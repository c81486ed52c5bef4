"""The port's activation dump/diff tool (cli/activation_diff.py) against the
JAX package's.  `diff` prints JAX's per-key lines on the same two files
and returns JAX's code (never skipped); a dump's self-diff is exact.  Both
packages' `dump` on one tiny reference-format checkpoint and one
media.io.encode_test_video clip write the same keys and shapes, equal
segment boundaries, and pass the port's `diff` at the tool's default
tolerance (3e-2); these skip where pkg-config finds no FFmpeg.  Both tools
ask their loader for bf16; the loaders are patched to f32 with an f32
compressor and a stub tokenizer (the parity setting of
tests/test_torch_serve.py: in bf16 the two frameworks' CPU roundings part
on the random tiny model)."""

import numpy as np
import pytest

from tdc_video_tpu.cli import activation_diff as jad
from tdc_video_tpu_torch.cli import activation_diff as tad
from tdc_video_tpu_torch.media import build as media_build

HAS_FFMPEG, FFMPEG_MSG = media_build.ffmpeg_libraries()
KEYS = {"siglip_feats", "dino_feats", "frame_feats", "boundaries", "visual", "text_logits"}


def _npz(path, seed, shift=0.0, drop=None, reshape=None):
    rng = np.random.default_rng(seed)
    out = {"frame_feats": rng.normal(size=(4, 6, 8)).astype(np.float32) + shift,
           "boundaries": np.array([True, False, True, False]),
           "visual": rng.normal(size=(10, 8)).astype(np.float32),
           "text_logits": rng.normal(size=(1, 5, 16)).astype(np.float32)}
    if drop:
        del out[drop]
    if reshape:
        out[reshape] = out[reshape].reshape(-1)
    np.savez_compressed(path, **out)
    return str(path)


@pytest.mark.parametrize("case", ["self", "near", "far", "missing_key", "shape"])
def test_diff_prints_jax_lines(tmp_path, capsys, case):
    a = _npz(tmp_path / "a.npz", 0)
    b = {"self": lambda: a,
         "near": lambda: _npz(tmp_path / "b.npz", 0, shift=1e-3),
         "far": lambda: _npz(tmp_path / "b.npz", 1),
         "missing_key": lambda: _npz(tmp_path / "b.npz", 0, drop="visual"),
         "shape": lambda: _npz(tmp_path / "b.npz", 0, reshape="visual")}[case]()
    rc = tad.main(["diff", a, b])
    printed = capsys.readouterr().out
    assert jad.main(["diff", a, b]) == rc
    assert capsys.readouterr().out == printed
    assert rc == (0 if case in ("self", "near", "missing_key") else 1)
    if case == "self":
        assert "worst rel: 0.000e+00" in printed


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    if not HAS_FFMPEG:
        pytest.skip(f"pkg-config finds no FFmpeg libraries: {FFMPEG_MSG}")
    import jax.numpy as jnp
    import torch

    from tdc_video_tpu.config import tdc_tiny
    from tdc_video_tpu_torch.media.io import encode_test_video
    from test_builder import write_checkpoint
    from test_torch_serve import _f32_loaders

    root = tmp_path_factory.mktemp("actdiff")
    ckpt = str(root / "ckpt")
    write_checkpoint(ckpt, tdc_tiny(), audio=False)
    vid = str(root / "v.mp4")
    encode_test_video(vid, w=160, h=120, fps=25.0, n_frames=100)
    mp = pytest.MonkeyPatch()
    asked = _f32_loaders(mp)
    argv = ["dump", "--model_path", ckpt, "--video", vid, "--question", "What happens?"]
    paths = {"jax": str(root / "jax.npz"), "port": str(root / "port.npz")}
    try:
        assert jad.main(argv + ["--out", paths["jax"]]) == 0
        assert tad.main(argv + ["--out", paths["port"], "--device", "cpu"]) == 0
    finally:
        mp.undo()
    assert asked == [("jax", jnp.bfloat16), ("torch", torch.bfloat16)]
    return paths


def test_dump_matches_jax_dump(dumps, capsys):
    j, t = np.load(dumps["jax"]), np.load(dumps["port"])
    assert set(t.files) == set(j.files) == KEYS
    for k in KEYS:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
    np.testing.assert_array_equal(t["boundaries"], j["boundaries"])
    assert t["frame_feats"].shape[0] == 8 and t["visual"].shape[0] > 0
    assert tad.main(["diff", dumps["port"], dumps["jax"]]) == 0
    printed = capsys.readouterr().out
    assert [ln.split(":")[0] for ln in printed.splitlines()[:-1]] == sorted(KEYS)


def test_dump_self_diff_is_exact(dumps, capsys):
    assert tad.main(["diff", dumps["port"], dumps["port"]]) == 0
    assert "worst rel: 0.000e+00" in capsys.readouterr().out
