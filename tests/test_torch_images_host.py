"""The port's host image path against PIL and the JAX package.

`pil_bicubic_resize` is a numpy copy of PIL's Image.resize(..., BICUBIC) on
8-bit RGB and must equal it bit for bit (tolerance 0): downscaling 640 ->
384 and 378 (the towers' sizes), upscaling 48 -> 384, non-square images and
equal sizes.  process_frames must equal the JAX package's (which calls PIL)
bit for bit at the presets' tower sizes and at tdc_tiny's.
"""

import numpy as np
import pytest

from tdc_video_tpu import config as jc
from tdc_video_tpu.data import images as jimages
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch.data import images as timages


def _image(kind, h, w, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    # smooth gradients with a few hard edges: every sum lands mid-range, so
    # the fixed-point rounding, not the clip, decides each pixel
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1), (x + y) % 97 * 2.6], -1)
    img[h // 3: h // 2, w // 4: w // 2] = (250, 10, 128)
    return np.clip(img, 0, 255).astype(np.uint8)


CASES = [
    ((640, 640), (384, 384)),
    ((640, 640), (378, 378)),
    ((48, 48), (384, 384)),
    ((360, 640), (384, 384)),
    ((480, 360), (378, 378)),
    ((120, 160), (99, 201)),
    ((384, 384), (384, 384)),
]


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("src,dst", CASES, ids=lambda s: "x".join(map(str, s)))
def test_pil_bicubic_bitwise(src, dst, kind):
    Image = pytest.importorskip("PIL.Image")
    img = _image(kind, *src)
    ref = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), Image.BICUBIC))
    out = timages.pil_bicubic_resize(img, dst[1], dst[0])
    assert out.dtype == np.uint8 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_expand2square_matches_jax():
    img = _image("noise", 30, 52)
    for fill in ((127, 127, 127), (123, 116, 103)):
        np.testing.assert_array_equal(timages.expand2square(img, fill),
                                      jimages.expand2square(img, fill))


@pytest.mark.parametrize("preset", ["llama32_3b", "tiny"])
def test_process_frames_bitwise_vs_jax(preset):
    """The whole host chain (pad to square with the tower mean, PIL bicubic,
    normalise) at the towers' sizes: SigLIP 384 and DINOv2 378 for the
    preset, 56 for tdc_tiny."""
    jcfg, tcfg = (jc.tdc_llama32_3b(), tc.tdc_llama32_3b()) if preset != "tiny" else \
        (jc.tdc_tiny(), tc.tdc_tiny())
    frames = [_image("noise", 120, 160, 1), _image("smooth", 120, 160), _image("noise", 120, 160, 2)]
    ref = jimages.process_frames(frames, jcfg)
    out = timages.process_frames(frames, tcfg)
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype == np.float32 and o.shape == r.shape
        np.testing.assert_array_equal(o, r)
    # and through pad_frames, as the predictor calls it
    for o, r in zip(timages.pad_frames(*out, 8), jimages.pad_frames(*ref, 8)):
        np.testing.assert_array_equal(o, r)
