"""The port's StreamingEncoder (serving/streaming.py) against the JAX
package's, on the CPU with shared tdc_tiny weights in f32 (f32
compressor): 14 frames at 1 fps in chunks of 4 (padded to 16), with host
preprocessing and with device preprocessing.  The mask and timestamps are
equal, the features and compressed tokens within 3e-4 and n_visual equal;
the port's chunked result is within JAX's own bound (1e-2,
tests/test_streaming.py) of its monolithic encode_frames + prepare_visual.

Three sources: an in-memory stand-in for media.io.decode_video_range (the
chunk-by-chunk path; needs no decoder), a GIF (unsliceable: the one-shot
fallback) and an MPEG-4 clip from media.io.encode_test_video (range
decode); the last two skip where pkg-config finds no FFmpeg.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdc_video_tpu import config as jc
from tdc_video_tpu import model as jmodel
from tdc_video_tpu.media import io as jio
from tdc_video_tpu.serving import streaming as jstream
from tdc_video_tpu_torch import config as tc
from tdc_video_tpu_torch import model as tmodel
from tdc_video_tpu_torch.data.images import device_preprocess, process_frames
from tdc_video_tpu_torch.media import build as media_build
from tdc_video_tpu_torch.media import io as tio
from tdc_video_tpu_torch.serving import streaming as tstream
from torch_parity import ATOL, RTOL, StandInMesh, close, to_torch

HAS_FFMPEG, FFMPEG_MSG = media_build.ffmpeg_libraries()
needs_ffmpeg = pytest.mark.skipif(not HAS_FFMPEG,
                                  reason=f"pkg-config finds no FFmpeg libraries: {FFMPEG_MSG}")
N, CHUNK = 14, 4


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jc.tdc_tiny(), compress_dtype=jnp.float32)
    tcfg = dataclasses.replace(tc.tdc_tiny(), compress_dtype=torch.float32)
    jp = jmodel.init_tdc(jax.random.PRNGKey(0), jc.tdc_tiny())
    return jcfg, jp, tcfg, to_torch(jp)


def _memory_frames():
    rng = np.random.default_rng(5)
    frames = np.repeat(rng.integers(0, 256, (N, 5, 6, 3), dtype=np.uint8), 8, axis=1)
    return np.repeat(frames, 10, axis=2)  # [14, 40, 60, 3], a new picture each second


@pytest.fixture
def source(request, tmp_path, monkeypatch):
    """(path, the frames it decodes to at 1 fps)."""
    kind = request.param
    if kind == "memory":
        frames = _memory_frames()

        def decode_range(path, k0, k1, fps=1.0, **kw):
            k1 = min(k1, N)
            return frames[k0:k1].copy(), np.arange(k0, k1, dtype=np.float64)

        monkeypatch.setattr(jio, "decode_video_range", decode_range)
        monkeypatch.setattr(tio, "decode_video_range", decode_range)
        return "in-memory", frames
    if not HAS_FFMPEG:
        pytest.skip(f"pkg-config finds no FFmpeg libraries: {FFMPEG_MSG}")
    if kind == "gif":
        from PIL import Image

        path = str(tmp_path / "c.gif")
        ims = [Image.new("RGB", (60, 40), ((i * 37) % 255, 30, 255 - (i * 31) % 255))
               for i in range(N)]
        ims[0].save(path, save_all=True, append_images=ims[1:], duration=1000, loop=0)
        assert tio.decode_video_range(path, 0, CHUNK) is None  # unsliceable: the fallback
    else:
        path = str(tmp_path / "c.mp4")
        tio.encode_test_video(path, w=64, h=48, fps=25.0, n_frames=25 * N)
        assert tio.decode_video_range(path, 0, CHUNK) is not None
    return path, tio.decode_video(path, fps=1.0, max_frames=100)[0]


CASES = [("memory", False), ("memory", True), ("gif", False), ("mp4", True)]


@pytest.mark.parametrize("source,device_prep", CASES, indirect=["source"],
                         ids=[f"{s}-{'device' if d else 'host'}" for s, d in CASES])
def test_stream_equals_jax_and_monolithic(models, source, device_prep):
    jcfg, jp, tcfg, tp = models
    path, frames = source
    assert len(frames) == N
    kw = dict(chunk_frames=CHUNK, max_frames=100, device_prep=device_prep)
    jenc = jstream.StreamingEncoder(jcfg, jp, **kw)
    tenc = tstream.StreamingEncoder(tcfg, tp, device="cpu", **kw)
    jff, jdf, jmask, jts, _ = jenc.encode_stream(path)
    ff, df, mask, ts, stats = tenc.encode_stream(path)

    assert stats.frames == N and ff.shape[0] == 16 and int(mask.sum()) == N
    assert stats.wall_s > 0 and stats.summary()["video_sec_per_sec"] > 0
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(ts, jts)
    close(ff, jff)
    close(df, jdf)
    jvis, jn, _ = jenc.compress(jff, jdf, jmask)
    vis, n, secs = tenc.compress(ff, df, mask)
    assert int(n) == int(jn) and secs > 0
    close(vis[: int(n)], np.asarray(jvis)[: int(jn)])

    # the port's monolithic path over the same frames, padded to 16
    if device_prep:
        u8 = np.concatenate([frames, np.zeros((16 - N,) + frames.shape[1:], np.uint8)])
        sig, dino = device_preprocess(torch.from_numpy(u8), tcfg)
    else:
        sig, dino = (torch.from_numpy(np.concatenate([x, np.zeros((16 - N,) + x.shape[1:], x.dtype)]))
                     for x in process_frames(list(frames), tcfg))
    mff, mdf = tmodel.encode_frames(tcfg, tp, sig, dino, attn_impl="flash")
    mvis, mn = tmodel.prepare_visual(tcfg, tp, mff, mdf, mask, torch.zeros(8, dtype=torch.int64),
                                     torch.zeros(8, dtype=torch.bool), max_visual_len=4096)
    assert int(mn) == int(n)
    close(vis[: int(n)], mvis[: int(mn)], atol=1e-2, rtol=1e-2)
    close(ff, mff, atol=ATOL, rtol=RTOL)


def test_mesh_raises(models):
    """A chunk the mesh's data axis does not divide raises (JAX's
    test_chunk_not_divisible_raises; the sharded encode itself:
    tests/test_torch_parallel_tp.py)."""
    _, _, tcfg, tp = models
    with pytest.raises(ValueError, match="does not divide"):
        tstream.StreamingEncoder(tcfg, tp, chunk_frames=CHUNK, mesh=StandInMesh(n_data=3),
                                 device="cpu")
    enc = tstream.StreamingEncoder(tcfg, tp, chunk_frames=CHUNK, mesh=StandInMesh(n_data=2),
                                   device="cpu")
    assert enc.device == torch.device("cpu")


def test_producer_error_reaches_the_caller(models, monkeypatch):
    _, _, tcfg, tp = models

    def broken(*a, **kw):
        raise IOError("range decode failed for x.mp4 (rc=-3)")

    monkeypatch.setattr(tio, "decode_video_range", broken)
    enc = tstream.StreamingEncoder(tcfg, tp, chunk_frames=CHUNK, device="cpu")
    with pytest.raises(IOError, match="rc=-3"):
        enc.encode_stream("x.mp4")
