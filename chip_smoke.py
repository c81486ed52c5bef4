"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py      # one card, no arguments

Phases, in order; any failure ends the run with a non-zero exit:

1. device and build: the card's name and power limit, the CUDA version, and
   an nvcc build of every kernel from tdc_video_tpu_torch/csrc/;
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes in bf16 (and a small f32 case), with error, time, the plain
   version's time, one F.scaled_dot_product_attention call as a yardstick
   (the port never calls it) and the least time the card could take;
3. the main path: TDC-Llama3.2-3B at full width and depth with random
   weights from a seed, answering one question about 16 synthetic 360x640
   frames through TDCPredictor.answer, with the kernels' launch counters set
   to 0 just before and read just after;
4. LM prefill of the same request with attn_impl="flash" and "xla" (plain
   sdpa): finite logits, the same argmax, a bounded difference;
5. torch.profiler over each stage of one more answer (device busy share,
   device time by kernel).

The line before the last is one JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}.  Needs CUDA: exits non-zero without.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
# H100 SXM published peaks (NVIDIA data sheet, dense, at a 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# bf16 kernel vs plain: both round P and O to bf16, at different row maxima
# (running vs final), so elements differ by a few bf16 ulps of |O| <~ 4.
BF16_ATOL = 3e-2
BF16_RTOL = 2e-2  # max|diff| / max|plain|
F32_ATOL = 1e-4  # f32 kernel vs plain: summation order only
# flash vs xla prefill logits at full depth in bf16: attention rounding
# differs per layer (P rounded at running vs final max, output rounding)
# and propagates through 28 layers; logits have std ~1.
LOGIT_ATOL = 0.25
QUESTION = "What happens in this video? Answer briefly."
N_FRAMES, FRAME_H, FRAME_W = 16, 360, 640
MAX_NEW_TOKENS = 16


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------


def phase_device_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from tdc_video_tpu_torch.ops import build

    paths, secs, out = build.build_all()
    log(f"[1] kernels built in {secs:.2f} s: {', '.join(p.name for p in paths.values())}")
    # ptxas -v: registers and spill bytes of each library's bf16 kernels
    for lib in out.split("--- nvcc ")[1:]:
        regs, spills, entry = [], 0, ""
        for line in lib.splitlines():
            if "Compiling entry function" in line:
                entry = line
            elif "bf16" in entry and "spill stores" in line:
                spills += int(re.search(r"(\d+) bytes spill stores", line).group(1))
            elif "bf16" in entry and "registers" in line:
                regs.append(int(re.search(r"Used (\d+) registers", line).group(1)))
        log(f"[1] ptxas {lib.split()[0]}: bf16 kernels use {min(regs)}-{max(regs)} registers, "
            f"{spills} bytes of spill stores")


# ---------------------------------------------------------------------------
# Phase 2
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int = 20, rounds: int = 5, warmup: int = 2) -> float:
    """Median over `rounds` of the mean time of `reps` back-to-back calls
    between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float):
    """Least time for the work: the larger of bf16 operations over the
    tensor-core peak and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _compare(name, out, ref, atol, rtol):
    diff = (out.float() - ref.float()).abs()
    max_abs = float(diff.max())
    max_rel = max_abs / max(float(ref.float().abs().max()), 1e-30)
    ok = bool(torch.isfinite(out).all()) and max_abs <= atol and max_rel <= rtol
    log(f"[2] {name}: max_abs {max_abs:.3e} (tol {atol:g}) max_rel {max_rel:.3e} "
        f"(tol {rtol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return max_abs


def phase_kernels(T: int, S: int):
    from tdc_video_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    rows = []
    specs = [
        # name, replaces, (B, T, S, Hq, Hkv, D), causal
        ("flash_kernel", "tdc_video_tpu/ops/flash_attention.py:38", (1, T, S, 24, 8, 128), True),
        ("full_attention_nhd", "tdc_video_tpu/ops/flash_attention.py:198",
         (N_FRAMES, 730, 730, 24, 24, 64), False),
        ("full_attention_nhd_seqq", "tdc_video_tpu/ops/flash_attention.py:242",
         (N_FRAMES, 729, 729, 16, 16, 72), False),
    ]
    for name, replaces, (B, Tq, Sk, Hq, Hkv, D), causal in specs:
        assert fa.select_kernel(Tq, Sk, Hq, Hkv, D, causal) == name
        scale = 1.0 / math.sqrt(D)
        if name == "flash_kernel":
            q, k, v = rnd(B, Tq, Hq, D), rnd(B, Sk, Hkv, D), rnd(B, Sk, Hkv, D)
            kern = lambda: fa.flash_kernel(q, k, v, scale, True)
            plain = lambda: fa.flash_attention_plain(q, k, v, scale, True)
            lib = lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k[:, :Tq].transpose(1, 2), v[:, :Tq].transpose(1, 2),
                is_causal=True, scale=scale, enable_gqa=True)
            pairs = Tq * (Tq + 1) // 2  # top-left causal: keys < T only
            kv_rows = min(Sk, Tq)
            out_bytes = B * Tq * Hq * D * 2 + B * Hq * Tq * 4  # o + f32 lse
        else:
            # packed [B, N, H*D] projections viewed as [B, N, H, D]
            q, k, v = (rnd(B, Tq, Hq * D).view(B, Tq, Hq, D) for _ in range(3))
            fn = getattr(fa, name)
            kern = lambda: fn(q, k, v, scale)
            plain = lambda: getattr(fa, name + "_plain")(q, k, v, scale)
            lib = lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale)
            pairs = Tq * Sk
            kv_rows = Sk
            out_bytes = B * Tq * Hq * D * 2
        out = kern()
        ref = plain()
        torch.cuda.synchronize()
        if name == "flash_kernel":
            _compare(name + " lse", out[1], ref[1], 1e-3, 1e-3)
            out, ref = out[0], ref[0]
        max_abs = _compare(name, out, ref, BF16_ATOL, BF16_RTOL)
        ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain, reps=3, rounds=3), time_ms(lib)
        flops = 4.0 * B * Hq * pairs * D
        nbytes = 2.0 * (B * Tq * Hq * D + 2 * B * kv_rows * Hkv * D) + out_bytes
        b_ms, b_by = bound_ms(flops, nbytes)
        log(f"[2] {name}: {ms:.3f} ms, plain {plain_ms:.3f} ms, sdpa {lib_ms:.3f} ms, "
            f"bound {b_ms:.3f} ms ({b_by}), {flops / ms / 1e9:.1f} TFLOP/s")
        rows.append({
            "name": name, "route": "cuda", "source": f"tdc_video_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": 0, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        })

        # f32 operands take the scalar path: a small case, tight tolerance
        small = dict(flash_kernel=(2, 150, 200, 4, 2, D),
                     full_attention_nhd=(2, 130, 130, 4, 4, D),
                     full_attention_nhd_seqq=(2, 145, 145, 16, 16, D))[name]
        B2, T2, S2, H2, Hk2, _ = small
        q2 = rnd(B2, T2, H2, D, dtype=torch.float32)
        k2, v2 = (rnd(B2, S2, Hk2, D, dtype=torch.float32) for _ in range(2))
        if name == "flash_kernel":
            o2, r2 = fa.flash_kernel(q2, k2, v2, scale, True)[0], fa.flash_attention_plain(q2, k2, v2, scale, True)[0]
        else:
            o2, r2 = getattr(fa, name)(q2, k2, v2, scale), getattr(fa, name + "_plain")(q2, k2, v2, scale)
        torch.cuda.synchronize()
        _compare(name + " f32", o2, r2, F32_ATOL, F32_ATOL)
    log("kernels " + json.dumps({r["name"]: {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
                                 for r in rows}))
    return rows


# ---------------------------------------------------------------------------
# Phases 3-4
# ---------------------------------------------------------------------------


class ByteTokenizer:
    """Byte-level ids inside the Llama vocabulary: byte b -> id 1000 + b.
    Special tokens of the prompt template map to their Llama-3 ids."""

    SPECIALS = {"<|begin_of_text|>": 128000, "<|start_header_id|>": 128006,
                "<|end_header_id|>": 128007, "<|eot_id|>": 128009}

    def encode(self, text: str):
        ids, i = [], 0
        while i < len(text):
            for s, sid in self.SPECIALS.items():
                if text.startswith(s, i):
                    ids.append(sid)
                    i += len(s)
                    break
            else:
                ids.extend(1000 + b for b in text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids):
        return bytes(int(t) - 1000 for t in ids if 1000 <= int(t) < 1256).decode("utf-8", "replace")


def synth_frames(seed: int) -> np.ndarray:
    """16 uint8 frames: a textured background and a bright square that moves,
    with a scene change every 4 frames (new background)."""
    rng = np.random.default_rng(seed)
    frames = np.empty((N_FRAMES, FRAME_H, FRAME_W, 3), np.uint8)
    for t in range(N_FRAMES):
        if t % 4 == 0:
            bg = rng.integers(0, 256, (FRAME_H // 8, FRAME_W // 8, 3), dtype=np.uint8)
            bg = np.kron(bg, np.ones((8, 8, 1), np.uint8))
        f = bg.copy()
        y, x = 40 + 15 * t, 60 + 30 * t
        f[y:y + 80, x:x + 80] = 255
        frames[t] = f
    return frames


def phase_main_path(rows):
    from tdc_video_tpu_torch.config import tdc_llama32_3b
    from tdc_video_tpu_torch.eval.runner import TDCPredictor
    from tdc_video_tpu_torch.model import init_tdc
    from tdc_video_tpu_torch.ops import flash_attention as fa

    cfg = tdc_llama32_3b()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = init_tdc(cfg, torch.Generator(device=dev).manual_seed(SEED), dev, torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[3] init_tdc {n_params / 1e9:.3f} B params bf16 in {time.perf_counter() - t0:.1f} s")
    frames = synth_frames(SEED)
    pred = TDCPredictor(cfg, params, ByteTokenizer(), bert_tokenizer=None, device=dev)

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    text = pred.answer(frames, QUESTION, max_new_tokens=MAX_NEW_TOKENS)
    wall = time.perf_counter() - t0
    counts = dict(fa.launches)
    ids = list(pred.stats.last_ids)
    st = pred.stats
    log(f"[3] answer ids {ids} text {text!r}")
    log(f"[3] first answer: wall {wall:.3f} s: encode {st.encode_s:.3f} s, compress+prefill "
        f"{st.prefill_s:.3f} s, decode {st.decode_s:.3f} s ({st.decode_steps} steps)")
    log(f"[3] max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[3] launches {json.dumps(counts)}")
    for r in rows:
        r["launches"] = counts[r["name"]]
        if r["launches"] <= 0:
            raise AssertionError(f"kernel {r['name']} was not launched on the main path")
    # the first answer pays one-time costs (allocator growth, library
    # heuristics); the second shows the steady state
    t0 = time.perf_counter()
    pred.answer(frames, QUESTION, max_new_tokens=MAX_NEW_TOKENS)
    wall = time.perf_counter() - t0
    if list(pred.stats.last_ids) != ids:
        raise AssertionError(f"second answer differs: {pred.stats.last_ids} vs {ids}")
    log(f"[3] second answer: identical ids; wall {wall:.3f} s: encode {st.encode_s:.3f} s, "
        f"compress+prefill {st.prefill_s:.3f} s, decode {st.decode_s:.3f} s")
    return cfg, params, pred, frames


def phase_flash_vs_xla(cfg, params, pred, frames):
    from tdc_video_tpu_torch.serving.generate import prefill_encoded

    req = pred.prepare(frames, QUESTION, max_new_tokens=MAX_NEW_TOKENS)
    logits = {}
    for impl in ("flash", "xla"):
        logits[impl] = prefill_encoded(cfg, params, **req["gen"], attn_impl=impl)[0].float()
    torch.cuda.synchronize()
    lf, lx = logits["flash"], logits["xla"]
    if not (torch.isfinite(lf).all() and torch.isfinite(lx).all()):
        raise AssertionError("non-finite prefill logits")
    top2 = torch.topk(lx[0], 2).values
    diff = float((lf - lx).abs().max())
    af, ax = int(lf.argmax(-1)[0]), int(lx.argmax(-1)[0])
    log(f"[4] prefill T={req['gen']['max_len']}: argmax flash {af} xla {ax}, max_abs diff "
        f"{diff:.4e} (tol {LOGIT_ATOL}), xla top-2 gap {float(top2[0] - top2[1]):.4e}")
    if af != ax or diff > LOGIT_ATOL:
        raise AssertionError("flash and xla prefill disagree")


def phase_profile(pred, frames) -> None:
    """torch.profiler over the stages of one more `answer` (encode; compress
    + prefill; compress + prefill + decode): wall time, the device's busy
    time and share, and device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tdc_video_tpu_torch.serving.generate import generate_encoded, prefill_encoded

    req = {}
    stages = [
        ("encode", lambda: req.update(pred.prepare(frames, QUESTION,
                                                   max_new_tokens=MAX_NEW_TOKENS))),
        ("compress+prefill", lambda: prefill_encoded(pred.cfg, pred.params, **req["gen"],
                                                     attn_impl=pred.attn_impl)),
        ("compress+prefill+decode", lambda: generate_encoded(pred.cfg, pred.params, **req["gen"],
                                                             attn_impl=pred.attn_impl)),
    ]
    for name, fn in stages:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        log(f"[5] {name}: wall {wall:.4f} s, device busy {busy:.4f} s "
            f"({100 * busy / wall:.1f}%), {sum(e.count for e in kernels)} device ops")
        for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
            log(f"[5]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_device_build()
    from tdc_video_tpu_torch.config import tdc_llama32_3b
    from tdc_video_tpu_torch.eval.runner import prefill_shape

    T, S = prefill_shape(tdc_llama32_3b(), ByteTokenizer(), QUESTION, N_FRAMES, MAX_NEW_TOKENS)
    log(f"[2] main-path prefill shape T={T} S={S}")
    rows = phase_kernels(T, S)
    cfg, params, pred, frames = phase_main_path(rows)
    phase_flash_vs_xla(cfg, params, pred, frames)
    phase_profile(pred, frames)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
