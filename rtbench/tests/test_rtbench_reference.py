"""The plain reference against the suite's golden images
(tests/golden/*.ppm, made by the independent native renderer), within
tests/test_golden.py's tolerances."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from rtbench import reference, scenes

torch.set_num_threads(4)
ROOT = Path(__file__).resolve().parents[2]
GOLDEN = ROOT / "tests" / "golden"


def _read_ppm(path: Path) -> np.ndarray:
    tok = path.read_bytes().split()
    w, h = int(tok[1]), int(tok[2])
    rgb = np.array(tok[4:4 + 3 * w * h], dtype=np.int64).reshape(h, w, 3)
    return ((rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
            ).astype(np.int32)


def _render(name: str, side: int, depth: int) -> np.ndarray:
    config = json.loads((ROOT / "rtbench" / "configs" / f"{name}.json")
                        .read_text())
    config.update(width=side, height=side)
    cpu = torch.device("cpu")
    img, _ = reference.trace(scenes.spheres(config, cpu),
                             scenes.camera(config, cpu), side, side, depth)
    return reference.pack(img).numpy()


def _gaps(img, ref):
    rgb = lambda p: np.stack([(p >> 16) & 255, (p >> 8) & 255, p & 255], -1)
    return (img != ref).mean(), np.abs(rgb(img) - rgb(ref)).mean()


def test_rgbbox_depth1_exact():
    np.testing.assert_array_equal(_render("rgbbox", 200, 1),
                                  _read_ppm(GOLDEN / "rgbbox_200_d1.ppm"))


@pytest.mark.parametrize("name, golden, mismatch, delta", [
    ("rgbbox", "rgbbox_200.ppm", 0.15, 6.0),
    ("irreg", "irreg_200.ppm", 0.02, 0.5)])
def test_full_depth_within_golden_tolerances(name, golden, mismatch, delta):
    m, d = _gaps(_render(name, 200, 50), _read_ppm(GOLDEN / golden))
    assert m <= mismatch and d <= delta, (m, d)
