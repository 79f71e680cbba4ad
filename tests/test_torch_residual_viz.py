"""The port's residual fields (``ezpz_tpu_torch.residual_viz``) against the
committed baselines and the JAX package's renders.

Each of the five fields is rendered on the CPU (``device="cpu"``) and must
score >= 0.99 against ``tests/residual_viz_baselines/<name>.png`` by
``compare_images``, as ``tests/test_residual_viz.py`` requires of the JAX
package, and equal JAX's render of the same field pixel for pixel (the
same f64 residual arithmetic, then the same numpy overlay).
"""

import os

import numpy as np
import pytest

from ezpz_tpu import residual_viz as JV
from ezpz_tpu_torch import residual_viz as TV

BASELINE_DIR = os.path.join(os.path.dirname(__file__), "residual_viz_baselines")
SCORE = 0.99
NAMES = ["points_coincident", "distance", "point_line_distance", "vertical", "horizontal"]


def render(rv, name, **kw):
    """``tests/test_residual_viz.py``'s render of ``name`` by module ``rv``."""
    view = (-6, 6, -6, 6, 240, 240)
    if name == "points_coincident":
        return rv.render_points_coincident(3.0, 2.0, *view, **kw)
    if name == "distance":
        return rv.render_distance(0.0, 0.0, 3.0, *view, **kw)
    if name == "point_line_distance":
        return rv.render_point_line_distance((0.0, 0.0), (2.0, 3.0), 1.0, *view, **kw)
    if name == "vertical":
        return rv.render_vertical(1.0, 0.0, *view, **kw)
    if name == "horizontal":
        return rv.render_horizontal(0.0, 1.0, *view, **kw)
    raise ValueError(name)


@pytest.mark.parametrize("name", NAMES)
def test_field_matches_baseline(name):
    import matplotlib.image

    img = render(TV, name, device="cpu")
    assert img.dtype == np.uint8 and img.shape == (240, 240, 3)
    baseline = (matplotlib.image.imread(os.path.join(BASELINE_DIR, f"{name}.png"))
                * 255).astype(np.uint8)[..., :3]
    score = TV.compare_images(img, baseline)
    assert score >= SCORE, f"{name}: visual score {score} < {SCORE}"


@pytest.mark.parametrize("name", NAMES)
def test_field_equals_jax_render(name):
    np.testing.assert_array_equal(render(TV, name, device="cpu"), render(JV, name))


def test_zero_locus_is_marked():
    """The solution set is turquoise: for distance, the target circle."""
    img = TV.render_distance(0.0, 0.0, 3.0, -6, 6, -6, 6, 240, 240, device="cpu")
    vp = TV.Viewport(-6, 6, -6, 6, 240, 240)
    px, py = vp.world_to_pixel(3.0, 0.0)
    assert tuple(img[py, px]) == tuple(TV.TURQUOISE)
    px, py = vp.world_to_pixel(-5.5, -5.5)
    assert tuple(img[py, px]) != tuple(TV.TURQUOISE)


def test_save_and_compare_round_trip(tmp_path):
    """``save_image`` writes a PNG that reads back to a score of 1.0, and
    ``compare_images`` scores shapes that differ 0.0."""
    import matplotlib.image

    img = render(TV, "vertical", device="cpu")
    path = tmp_path / "vertical.png"
    TV.save_image(img, str(path))
    back = (matplotlib.image.imread(str(path)) * 255).astype(np.uint8)[..., :3]
    assert TV.compare_images(img, back) == 1.0
    assert TV.compare_images(img, img[:10]) == 0.0
