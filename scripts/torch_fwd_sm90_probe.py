"""Probe instances of the port's sm_90a forward template on one CUDA card.

    python scripts/torch_fwd_sm90_probe.py

Builds scripts/torch_fwd_sm90_probe.cu with nvcc (the port's flags, plus
-I tdc_video_tpu_torch/csrc) into tdc_video_tpu_torch/_build/, prints each
instance's registers and spill bytes from ptxas, holds every instance
against the plain version (o within 3e-2, or within 2e-2 of each causal
row's norm; lse within 1e-3; at ragged lengths, lengths a multiple of the
key tile, GQA; two calls bitwise equal) and times each, in three passes
(the second in reverse order), beside the port's own kernel for the shape
and F.scaled_dot_product_attention: the causal DP = 128 instances at K1's
shapes of chip_smoke.py (stage-2 T = 8192, serving T = 1416 into S = 1432),
the non-causal DP = 64 and 80 ones at the towers' (K2 and K3 at 16 frames,
K4 at 8 frames with the lse).  The numbers behind fwd90::Tuned
(tdc_video_tpu_torch/csrc/flash_fwd_sm90.cuh).  Exits non-zero without a
card.
"""

from __future__ import annotations

import ctypes
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.append(str(ROOT))

from tdc_video_tpu_torch.ops import build  # noqa: E402
from tdc_video_tpu_torch.ops import flash_attention as fa  # noqa: E402

SOURCE = Path(__file__).resolve().with_suffix(".cu")
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense, at 700 W
_P, _I = ctypes.c_void_p, ctypes.c_int
# (label, B, T, S, Hq, Hkv, D, causal, with lse, the port's kernel for the shape)
SHAPES = [("K1 stage-2", 1, 8192, 8192, 24, 8, 128, True, True, "flash_kernel"),
          ("K1 serving", 1, 1416, 1432, 24, 8, 128, True, True, "flash_kernel"),
          ("K2 DINOv2", 16, 730, 730, 24, 24, 64, False, False, "full_attention_nhd"),
          ("K4 DINOv2", 8, 730, 730, 24, 24, 64, False, True, "full_attention"),
          ("K3 SigLIP", 16, 729, 729, 16, 16, 72, False, False, "full_attention_nhd_seqq"),
          ("K4 SigLIP", 8, 729, 729, 16, 16, 72, False, True, "full_attention")]
# (B, T, S, Hq, Hkv) checked at each probe's head dim: ragged lengths,
# lengths a multiple of the 64- and 128-key tiles, below one tile, GQA;
# S > T for the causal ones
CHECKS = {False: [(2, 145, 145, 4, 4), (2, 640, 640, 4, 4), (1, 768, 768, 3, 3),
                  (2, 100, 100, 4, 4), (2, 145, 145, 4, 2), (1, 1000, 1000, 2, 2),
                  (1, 729, 729, 6, 6)],
          True: [(1, 200, 200, 6, 2), (2, 129, 145, 3, 1), (1, 1000, 1016, 6, 2),
                 (1, 640, 640, 2, 2)]}


def time_ms(fn, reps: int = 20, rounds: int = 5, warmup: int = 2) -> float:
    """Median over rounds of the mean of reps back-to-back calls (CUDA events)."""
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


def load():
    """Compile the probe library; returns (library, ptxas output, seconds)."""
    t0 = time.perf_counter()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / f"libtorch_fwd_sm90_probe.{os.getpid()}.so"
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                          "-I", str(build.CSRC), "-o", str(out), str(SOURCE)],
                         capture_output=True, text=True, timeout=1200)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(str(out))
    out.unlink()
    for fn in ("count", "dp", "causal"):
        getattr(lib, f"tdc_fwd_sm90_probe_{fn}").restype = _I
    lib.tdc_fwd_sm90_probe_dp.argtypes = lib.tdc_fwd_sm90_probe_causal.argtypes = [_I]
    lib.tdc_fwd_sm90_probe_name.argtypes = [_I]
    lib.tdc_fwd_sm90_probe_name.restype = ctypes.c_char_p
    lib.tdc_fwd_sm90_probe_fwd.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                           ctypes.POINTER(ctypes.c_int64), ctypes.c_float, _P]
    lib.tdc_fwd_sm90_probe_fwd.restype = _I
    lib.tdc_error_string.argtypes = [_I]
    lib.tdc_error_string.restype = ctypes.c_char_p
    return lib, res.stdout + res.stderr, time.perf_counter() - t0


def ptxas_lines(log: str):
    """(instance label, registers, spill-store bytes) of each template
    instance, the label built from its mangled template arguments (ptxas
    prints an entry's spills before its registers)."""
    out, label, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            args = [int(x) for x in re.findall(r"L[ib](\d+)E", m.group(1))]
            label, spill = None, 0
            if "flash_fwd_bf16_sm90_kernel" in m.group(1) and len(args) == 7:
                dp, causal, lse, kr, nwg, pers, preg = args
                label = (f"DP{dp}{' causal' if causal else ''} K{kr} WG{nwg}"
                         + (" persistent" if pers else "") + (f" reg{preg}" if preg else "")
                         + (" lse" if lse else ""))
        elif label and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif label and "Used" in line and "registers" in line:
            out.append((label, int(re.search(r"Used (\d+) registers", line).group(1)), spill))
    return out


def call(lib, i, q, k, v, scale, with_lse):
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, T, 1), dtype=torch.float32, device=q.device) if with_lse else None
    strides = (ctypes.c_int64 * 12)(*fa.fwd_operand_strides("full_attention", q, k, v), *o.stride()[:3])
    err = lib.tdc_fwd_sm90_probe_fwd(i, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                     None if lse is None else lse.data_ptr(), B, T, S, Hq, Hkv, D, S,
                                     strides, float(scale), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"probe {i}: {lib.tdc_error_string(err).decode()}")
    return o, lse


def operands(g, B, T, S, Hq, Hkv, D, causal):
    """K1's separate q, k, v; or the towers' packed [B, N, H*D] projections
    viewed as [B, N, H, D]."""
    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    if causal:
        return rnd(B, T, Hq, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    return (rnd(B, T, Hq * D).view(B, T, Hq, D), rnd(B, S, Hkv * D).view(B, S, Hkv, D),
            rnd(B, S, Hkv * D).view(B, S, Hkv, D))


def o_error(o, ro, causal):
    """max abs error, or for causal rows the worst error relative to the
    row's norm (late rows average thousands of keys)."""
    d = o.float() - ro.float()
    if not causal:
        return float(d.abs().max())
    return float((d.norm(dim=-1) / ro.float().norm(dim=-1).clamp_min(1e-6)).max())


def main() -> int:
    if not torch.cuda.is_available():
        print("fwd_sm90 probe: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    lib, log, secs = load()
    print(f"built {SOURCE.name} in {secs:.1f} s", flush=True)
    for label, regs, spill in ptxas_lines(log):
        print(f"ptxas {label}: {regs} registers, {spill} bytes spill stores")
    probes = [(i, lib.tdc_fwd_sm90_probe_name(i).decode(), lib.tdc_fwd_sm90_probe_dp(i),
               bool(lib.tdc_fwd_sm90_probe_causal(i)))
              for i in range(lib.tdc_fwd_sm90_probe_count())]
    g = torch.Generator(device="cuda").manual_seed(0)

    bad = []
    for i, name, dp, causal in probes:
        D = {64: 64, 80: 72, 128: 128}[dp]
        worst_o = worst_l = 0.0
        for B, T, S, Hq, Hkv in CHECKS[causal]:
            q, k, v = operands(g, B, T, S, Hq, Hkv, D, causal)
            scale = 1.0 / math.sqrt(D)
            o, lse = call(lib, i, q, k, v, scale, True)
            o2, _ = call(lib, i, q, k, v, scale, False)
            ro, rl = fa._attention_plain(q, k, v, scale, causal)
            torch.cuda.synchronize()
            worst_o = max(worst_o, o_error(o, ro, causal))
            worst_l = max(worst_l, float((lse - rl).abs().max()))
            if not (torch.isfinite(o).all() and torch.equal(o, o2)):
                bad.append(f"{name} at {(B, T, S, Hq, Hkv)}: non-finite or not deterministic")
        tol = 2e-2 if causal else 3e-2
        ok = worst_o <= tol and worst_l <= 1e-3
        print(f"check {name}: max {'row ' if causal else ''}|o - plain| {worst_o:.3e} (tol {tol}), "
              f"max |lse - plain| {worst_l:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(name)

    for label, B, T, S, H, Hkv, D, causal, with_lse, port in SHAPES:
        q, k, v = operands(g, B, T, S, H, Hkv, D, causal)
        scale = 1.0 / math.sqrt(D)
        dp = {64: 64, 72: 80, 128: 128}[D]
        fns = {name: (lambda i=i: call(lib, i, q, k, v, scale, with_lse))
               for i, name, p_dp, p_causal in probes if p_dp == dp and p_causal == causal}
        kern = getattr(fa, port)
        fns[f"port {port}"] = ((lambda: kern(q, k, v, scale, True)) if causal
                               else (lambda: kern(q, k, v, scale)))
        fns["sdpa"] = lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :T].transpose(1, 2), v[:, :T].transpose(1, 2), scale=scale,
            is_causal=causal, enable_gqa=True)
        order = list(fns)
        times = {n: [] for n in order}
        for rnd in range(3):
            for n in (order if rnd % 2 == 0 else order[::-1]):
                times[n].append(time_ms(fns[n]))
        pairs = T * (T + 1) // 2 if causal else T * S
        flops = 4.0 * B * H * pairs * D
        bound = flops / PEAK_BF16_FLOPS * 1e3
        print(f"time {label} q [{B}, {T}, {H}x{D}] kv [{S}, {Hkv}]{' causal' if causal else ''}"
              f"{' lse' if with_lse else ''}: bound {bound:.4f} ms ({smi})")
        for n in order:
            t = min(times[n])
            print(f"time   {n:42s} {' / '.join(f'{x:.4f}' for x in times[n])} ms  "
                  f"{flops / t / 1e9:6.1f} TFLOP/s  {100 * bound / t:5.1f}% of bound", flush=True)
    if bad:
        print(f"FAILED: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
