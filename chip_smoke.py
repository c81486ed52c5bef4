"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py      # one card, no arguments

Phases, in order; any failure ends the run with a non-zero exit:

1. device and build: the card's name and power limit, the CUDA version, and
   an nvcc build of all six kernel libraries from tdc_video_tpu_torch/csrc/
   (one nvcc per source, all started together), with ptxas's registers and
   spills (the log each library was built with); in the sm_90a libraries
   (all six: K1-K4, whose bf16 body above head dim 32 is the wgmma forward
   template, K5 and K6) no bf16 kernel may spill, ptxas must not serialize
   a wgmma (warnings C7511-C7513), and cuobjdump must find HGMMA (wgmma)
   instructions in each instance of their wgmma kernels;
2. each kernel against its plain PyTorch version on the card, at its paths'
   shapes in bf16 (and a small f32 case), with error, time, the plain
   version's time, a PyTorch yardstick the port never calls (one
   F.scaled_dot_product_attention call for the forward kernels; its
   backward, forward+backward less forward, for K5 and K6) and the least
   time the card could take; K1 also at the stage-2 LM shape (T = S =
   8192), its o held row by row (each query's o) at both shapes; K5 and K6
   are held row by row (each query's dQ, each key's dK and dV) at the
   stage-2 LM shape and both tower shapes, and timed as a pair against the
   SDPA backward;
3. the serving path: TDC-Llama3.2-3B at full width and depth with random
   weights from a seed, answering one question about 16 synthetic 360x640
   frames through TDCPredictor.answer, with the kernels' launch counters set
   to 0 just before and read just after;
4. LM prefill of the same request with attn_impl="flash" and "xla" (plain
   sdpa): finite logits, the same argmax, a bounded difference;
5. torch.profiler over each stage of one more answer (device busy share,
   device time by kernel; K2's device time per launch in encode goes into
   its entry of the kernels line beside `ms`, which includes the wrapper's
   host work);
6. the training path: the stage-2 video-SFT preset (f32 master params, bf16
   compute, towers frozen) at full width and depth, one synthetic sample of
   64 frames and a Llama-3 conversation padded to 8192 tokens.  First one
   loss-and-gradient pass with attn_impl="flash" and one with "xla", held
   to each other (the loss, all LM gradients, and each layer's q/k/v/o
   projection gradient on its own); then 2 optimizer steps (4 micro-steps) through
   Trainer.train_step, with the launch counters read per micro-step, and a
   fifth micro-step under torch.profiler; then lm_loss's chunked head alone
   (forward, recompute and backward at 8191 rows), timed through the port's
   head (bf16 GEMMs with f32 output) and through the f32 product it
   replaced, on the same inputs;
7. the same preset with the towers trainable and the LM frozen: 2 optimizer
   steps of one micro-step each (the first update of a warmup from 0 has
   learning rate 0), which run the tower backward (K4, K5, K6), and a third
   under torch.profiler (device time by kernel, busy share, K4's share).  8
   frames, cut to 4 and then 2 if a step runs out of memory (the cut is
   printed, and K4's row is measured again at the frame count that ran);
8. checkpoint and demo: TDC-Llama3.2-3B at full width, its depths cut to
   4 LM, 4 SigLIP and 4 DINOv2 layers (an f32 checkpoint at full depth is
   about 20 GB), initialised from the seed and written with
   convert/to_hf.save_checkpoint_dir into a temporary directory; loaded back
   with builder.load_pretrained_model as the demo loads it (bf16 compute,
   f32 weights; seconds, GB/s, peak device memory), the loaded weights
   bitwise equal to the in-memory ones and the answer token-identical; the
   same model on the default host preprocessing path (its encode time beside
   the device path's; where PIL is installed, the port's copy of its bicubic
   resize held to it bit for bit on every frame at both tower sizes and
   timed beside it); and cli/demo.run on a 16 s clip from media.io.encode_test_video,
   decoded at 1 fps, answering on the card with K1-K3 launched.  Whether
   the machine has FFmpeg's libraries is asked of pkg-config before the
   phase: without them the clip leg alone is skipped, with pkg-config's
   message on its own line;
9. audio-visual QA: TDC-Qwen2-7B with audio (BEATs base, 12 layers at 768)
   at full width and depth, random bf16 weights from the seed, answering
   the phase-3 question about a 96 s clip as the demo sends it: 96 frames
   decoded at 1 fps (seconds 0, 1, ..., 95) and the clip's synthetic 96 s
   soundtrack (tones and noise, silent after 90 s; its tenth 10-s window
   is partly padding).  At 96 frames the request's own visual cap keeps
   every chunk whole, so the audio tokens reach the LM (a clip of 25 frames
   or fewer makes each frame its own chunk, and the cap then cuts every
   chunk's audio).  Checked: K1-K3 launched (counters set to 0 just before
   the warm answer and read just after); K1 at this prefill's shape
   (Qwen2-7B's GQA, 28 query over 4 KV heads) held to its plain version row
   by row and timed beside SDPA (its own entry of the kernels line); flash
   vs xla prefill logits of this request at phase 4's bounds; the audio
   adding 50 tokens to each chunk's static block at the request's own cap
   and moving the prefill logits there; encode_audio on the
   card against the host CPU in f32 (cuFFT, the cuDNN grouped conv and the
   pooling gather, none of which the CPU tests run) and two card calls
   bitwise equal.  Printed: encode_audio's stages (fbank, BEATs, pooling),
   the warm answer's wall time and stages, peak device memory, the audio
   encode's device busy share under torch.profiler, decode seconds per
   token and the untied head's lm_head time per step (and that of the f32
   product it replaced).  Every kernel's entry gets its launches on this
   path (`launches_av`);
10. the demo's serving options, run right after phase 5 on phase 3's model
   and request, each leg printing one JSON line with the card: (a) a
   weight-only int8 copy of the LM: prefill logits within 0.05 (relative
   to their max) of the bf16 ones, answer agreement, decode ms a token and a
   step, lm_head ms, peak memory; (b) the LM and both towers int8, the
   towers' static scales calibrated on the request's own frames, act-quant
   prefill: its logits within 0.08 of the bf16 LM's on the same inputs,
   the encode features within 0.08 (norm) of the bf16 towers', the
   end-to-end logits' drift printed, encode and prefill seconds against
   bf16, K2 and K3 launched; (c) an int8 KV cache: prefill and first decode-step
   logits within 0.05 of the bf16 cache's, decode ms, K1 launched; (d)
   speculative decoding with a window of 8: the answer token-identical to
   the plain one, or parting first where the plain run's top-2 logit gap is
   under 1e-2 (printed), verify steps and tokens per step; (e) a
   torch.profiler trace of one answer written by utils/profiling.trace,
   which must name a K1 launch.  The quantized copies are freed before
   phase 6; each kernel's entry gets its launches on legs (a)-(d)
   (`launches_int8`, `launches_int8_all`, `launches_kv_int8`,
   `launches_spec`).

11. stage 3 (audio-visual LoRA, the stage3_audio_lora preset: r 128, alpha
   256, accumulation 2, loss_chunk 512, 8192 rows), run right after phase 9
   on phase 9's TDC-Qwen2-7B(audio) bf16 tensors as the frozen base (a cut:
   the preset keeps f32 weights; linear casts each weight to bf16 at use, so
   the products do not change) with f32 copies of the trainable extras
   (SVA, compressor, image_newline, audio_proj) and f32 adapters; one
   synthetic sample of 64 frames with its 64 s soundtrack.  (a) LoRA: 2
   optimizer steps (4 micro-steps) through Trainer.train_step with the
   launch counters read per micro-step (K1 56, K5 28, K6 28, K2 40, K3 27,
   K4 0), a fifth micro-step under torch.profiler, non-pad tokens/s and
   peak memory; the LM base bitwise unchanged; (b) one loss-and-gradient
   pass with "flash" and one with "xla" on the LoRA view: losses within
   phase 6's 0.05, the cosine of all A/B gradients and of each layer's
   q/k/v/o adapters alone at least 0.99; (c) K1, K5 and K6 at this path's
   shape ([1, 8192, 28/4, 128]) held row by row to their plain versions at
   phase 2's bound and timed beside SDPA or its backward; (d) QLoRA, the
   same with quantize_frozen="int8" (the LM's linears and head and both
   towers int8, the bf16 base freed): 2 optimizer steps, peak memory, and
   export_merged against dequantize + merge recomputed on the host; (e) on
   the model at full width with phase 8's depth cut: a QLoRA Trainer's save
   restored by a new Trainer bitwise in every dtype, its merged export
   written with save_checkpoint_dir and loaded with load_pretrained_model,
   answering token-identically to the merged params in memory, and
   train.run.main --stage 3 --max_steps 2 --report_to jsonl on a synthetic
   data.json (.npy frames; a wav a row where FFmpeg's libraries exist),
   ending with a final/ that loads; whether torch.utils.tensorboard imports.
   Every kernel's entry gets its launches on legs (a) and (d)
   (`launches_lora`, `launches_qlora`); K1, K5 and K6 get entries at the
   stage-3 shape.
12. multi-request serving, run right after phase 10 on phase 3's model and
   frames (sent with a video_uid), one JSON line a leg with the card: (a)
   TDCPredictor.answer_many of 4 questions (phase 3's and three of other
   lengths) in 4 slots, 16 new tokens: each answer token-identical to
   `answer` on its question alone, or parting first where the solo run's
   top-2 logit gap is under 1e-2; one prefix prefill (the Q-Former is
   unconditioned, so the video prefix is shared); the towers run once and
   K1 only in the prefix prefill (launches K1 28, K2 40, K3 27, exactly);
   printed: the wall beside the 4 solo answers', the shared prefix, the
   time to each first token and the steady decode tokens/s at 4 slots and
   at 1 (the decode chunks' own seconds); (b) the same with
   prefill_chunk=512: the tokens of (a) or a near tie, the prefill chunks
   and the largest gap between decode chunks; (c) sampled as the reference
   demo samples (temperature 0.2, top_k 50), seed 0: two runs identical, 1
   and 4 slots identical for each question or parting on a near tie of the
   gumbel-perturbed logits (under 1e-2 over the temperature), a mixed batch
   whose greedy rows equal (a)'s and sampled rows the all-sampled run's,
   and sample_rows on the card equal to the host CPU's on the same logits;
   (d) the engine speculating with a window of 8: (a)'s tokens or a near
   tie, verify steps; (e) a 3-turn ChatSession: turn 2 token-identical to a
   from-scratch prefill of the two-turn prompt or parting on a near tie,
   kv_len growing, turns 2-3 launching no tower kernel, the turn walls.
   Every kernel's entry gets its launches in (a) and over the 3 turns of
   (e) (`launches_serve`, `launches_chat`).  Phase 8's clip leg also runs
   cli/serve (2 questions, 2 slots) on its checkpoint and clip.

The line before the last is one JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}.  Needs CUDA: exits non-zero without.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

# the tower-trainable step (phase 7) peaks within a few GiB of the card's
# memory: growable segments keep the allocator from failing on fragmentation
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

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
# K1's o and the backward kernels' dQ, dK, dV vs plain, bf16: each rounded to
# bf16 once from f32 sums taken in another order over P (and dS) rounded at
# the same places or at another row maximum.  Held per row (_compare_rows).
# A late causal row that skipped one 64-wide tile of its ~T random terms
# would move by ~sqrt(64 / T) of its norm, 9% at T=8192
ROW_RTOL = 2e-2
TRAIN_T = 8192  # stage-2 model_max_length
# training shapes: stage 2 at model_max_length tokens; the tower-trainable
# step's frame count (phase 7), which the K4-K6 tower timings use
TRAIN_FRAMES = 64
TRAIN_TEXT_LEN = 2048
TOWER_FRAMES = 8
LM_T_CHECK = 2048  # K5/K6 against their plain versions at the LM's widths
# flash vs xla stage-2 loss in bf16 at full depth: per-token logits differ
# by <~0.1 (phase 4 bound 0.25 on single logits); the mean CE over
# thousands of tokens differs far less
LOSS_ATOL = 0.05
GRAD_COS_MIN = 0.99
# launches per micro-step: K1 28 forward + 28 remat recompute; K5/K6 once
# per LM layer; K2 40 (DINOv2) and K3 27 (SigLIP) tower forwards; with the
# towers trainable K4 recomputes each of the 67 tower attentions and K5/K6
# run there too
DEVICE = "cuda"
STAGE2_LAUNCHES = {"flash_kernel": 56, "full_attention_nhd": 40, "full_attention_nhd_seqq": 27,
                   "full_attention": 0, "flash_dq_kernel": 28, "flash_dkv_kernel": 28}
TOWER_LAUNCHES = {"flash_kernel": 56, "full_attention_nhd": 40, "full_attention_nhd_seqq": 27,
                  "full_attention": 67, "flash_dq_kernel": 95, "flash_dkv_kernel": 95}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 1
# ---------------------------------------------------------------------------


def ptxas_report(lib: str):
    """One library's nvcc -Xptxas -v output: (source name, registers of each
    bf16 kernel, their spill-store bytes, the bf16 kernels whose wgmma ptxas
    serialized (warning C7512; a warning that names no function counts))."""
    name = lib.split()[0][:-len(".cu")]
    regs, spills, serialized, entry = [], 0, [], ""
    for line in lib.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "(C7512)" in line or ("wgmma" in line and "serialized" in line):
            fn = re.search(r"function '(\w+)'", line)
            if fn is None or "bf16" in fn.group(1):
                serialized.append(fn.group(1) if fn else line.strip())
        elif "bf16" in entry and "spill stores" in line:
            spills += int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif "bf16" in entry and "registers" in line:
            regs.append(int(re.search(r"Used (\d+) registers", line).group(1)))
    return name, regs, spills, serialized


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device_build():
    log(card())
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from tdc_video_tpu_torch.ops import build

    paths, secs, out = build.build_all()
    log(f"[1] kernels built in {secs:.2f} s: {', '.join(p.name for p in paths.values())}")
    # ptxas -v (the log each library was built with)
    for lib in out.split("--- nvcc ")[1:]:
        name, regs, spills, serialized = ptxas_report(lib)
        log(f"[1] ptxas {name}.cu: bf16 kernels use {min(regs)}-{max(regs)} registers, "
            f"{spills} bytes of spill stores, {len(serialized)} with serialized wgmma")
        if name in build.SM90 and (spills or serialized):
            raise AssertionError(f"{name}: the bf16 kernels spill {spills} bytes; "
                                 f"ptxas serialized the wgmma of {serialized}")
    # the sm_90a kernels run on wgmma: HGMMA instructions in the machine code
    # of each (the forward template's instances in K1-K4, K5, K6)
    cuobjdump = shutil.which("cuobjdump") or os.path.join(os.path.dirname(build.nvcc_path()),
                                                         "cuobjdump")
    for name, kernel in build.SM90.items():
        sass = subprocess.run([cuobjdump, "-sass", str(paths[name])], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        funcs = re.split(r"\n\s*Function : ", sass)[1:]
        hgmma = {f.split("\n", 1)[0]: f.count("HGMMA.") for f in funcs if kernel in f.split("\n", 1)[0]}
        log(f"[1] cuobjdump {name}: {sum(hgmma.values())} HGMMA instructions in {len(hgmma)} "
            f"{kernel} instances (fewest {min(hgmma.values(), default=0)})")
        if not hgmma or min(hgmma.values()) == 0:
            raise AssertionError(f"{name}: a {kernel} instance has no HGMMA instruction")


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


def _fwd_row(fa, rnd, name, replaces, dims, causal):
    """One forward kernel (K1-K3) against its plain version at `dims` = (B,
    T, S, Hq, Hkv, D), timed beside the plain version and SDPA; returns its
    entry of the kernels line."""
    B, Tq, Sk, Hq, Hkv, D = dims
    shape = f"q [{B}, {Tq}, {Hq}, {D}], kv [{B}, {Sk}, {Hkv}, {D}]"
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
        # late causal rows average thousands of keys, so |o| there is far
        # below max|o|: each query's o is held to its own norm
        _compare(f"{name} {shape} lse", out[1], ref[1], 1e-3, 1e-3)
        max_abs = _compare_rows(f"{name} {shape}", out[0], ref[0], ROW_RTOL)
    else:
        max_abs = _compare(f"{name} {shape}", out, ref, BF16_ATOL, BF16_RTOL)
    ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain, reps=3, rounds=3), time_ms(lib)
    flops = 4.0 * B * Hq * pairs * D
    nbytes = 2.0 * (B * Tq * Hq * D + 2 * B * kv_rows * Hkv * D) + out_bytes
    b_ms, b_by = bound_ms(flops, nbytes)
    log(f"[2] {name} {shape}: {ms:.4f} ms, plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.1f}% of it), {flops / ms / 1e9:.1f} TFLOP/s")
    return {
        "name": name, "route": "cuda", "source": f"tdc_video_tpu_torch/csrc/{name}.cu",
        "replaces": replaces, "shape": shape,
        "launches": 0, "max_abs_err": max_abs, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "tflops": flops / ms / 1e9, "bound_share": b_ms / ms,
    }


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
        rows.append(_fwd_row(fa, rnd, name, replaces, (B, Tq, Sk, Hq, Hkv, D), causal))
        scale = 1.0 / math.sqrt(D)

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


def _row(name, shape, replaces, max_abs, ms, plain_ms, lib_ms, flops, nbytes):
    """One entry of the kernels line, logged with its TFLOP/s."""
    b_ms, b_by = bound_ms(flops, nbytes)
    log(f"[2] {name} {shape}: {ms:.4f} ms, plain {plain_ms:.3f} ms, yardstick {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.1f}% of it), {flops / ms / 1e9:.1f} TFLOP/s")
    return {
        "name": name, "route": "cuda", "source": f"tdc_video_tpu_torch/csrc/{name}.cu",
        "replaces": replaces, "shape": shape, "launches": 0, "max_abs_err": max_abs, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "tflops": flops / ms / 1e9, "bound_share": b_ms / ms,
    }


def _rnd_fn(seed: int):
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=DEVICE, dtype=torch.float32).to(dtype)

    return rnd


def _towers(frames: int):
    return {"DINOv2": (frames, 730, 24, 64), "SigLIP": (frames, 729, 16, 72)}


def k4_row(frames: int):
    """K4 (non-causal full attention with lse, packed [B, N, H*D]
    projections) against its plain version and timed at both tower shapes
    of `frames` frames, plus a small f32 case; returns the DINOv2 row."""
    from tdc_video_tpu_torch.ops import flash_attention as fa

    rnd = _rnd_fn(SEED + 3)
    rows = []
    for tower, (B, N, H, D) in _towers(frames).items():
        scale = 1.0 / math.sqrt(D)
        q, k, v = (rnd(B, N, H * D).view(B, N, H, D) for _ in range(3))
        o, lse = fa.full_attention(q, k, v, scale)
        o_r, lse_r = fa.full_attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        _compare(f"full_attention {tower} lse", lse, lse_r, 1e-3, 1e-3)
        max_abs = _compare(f"full_attention {tower}", o, o_r, BF16_ATOL, BF16_RTOL)
        ms = time_ms(lambda: fa.full_attention(q, k, v, scale))
        plain_ms = time_ms(lambda: fa.full_attention_plain(q, k, v, scale), reps=3, rounds=3)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale))
        rows.append(_row("full_attention", f"{tower} [{B}, {N}, {H}x{D}]",
                         "tdc_video_tpu/ops/flash_attention.py:104", max_abs, ms, plain_ms, lib_ms,
                         4.0 * B * H * N * N * D, 2.0 * 4 * B * N * H * D + 4.0 * B * H * N))
        q2, k2, v2 = (rnd(2, 145, 4, D, dtype=torch.float32) for _ in range(3))
        o2, l2 = fa.full_attention(q2, k2, v2, scale)
        r2, rl2 = fa.full_attention_plain(q2, k2, v2, scale)
        torch.cuda.synchronize()
        _compare(f"full_attention {tower} f32", o2, r2, F32_ATOL, F32_ATOL)
        _compare(f"full_attention {tower} f32 lse", l2, rl2, F32_ATOL, F32_ATOL)
    return rows[0]


def _compare_rows(name, out, ref, rtol):
    """A gradient held row by row (one query's dQ, one key's dK or dV):
    |out_r - ref_r| <= rtol * max(|ref_r|, RMS of |ref_r| / 10), so late
    causal rows, whose gradients are small, are held to their own size.
    Returns max|out - ref|."""
    o, r = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    err, norm = (o - r).norm(dim=-1), r.norm(dim=-1)
    floor = max(0.1 * float(norm.square().mean().sqrt()), 1e-30)
    worst = float((err / norm.clamp_min(floor)).max())
    max_abs = float((o - r).abs().max())
    ok = bool(torch.isfinite(out).all()) and worst <= rtol
    log(f"[2] {name}: worst row |err|/|ref| {worst:.3e} (tol {rtol:g}), max_abs {max_abs:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return max_abs


def _bwd_rows(rnd, label, dims, causal, packed, dtype, timed):
    """K5 and K6 against their plain versions row by row at dims = (B, T,
    Hq, Hkv, D), on inputs from the kernel forward (K1, or K4 for packed
    tower projections); when `timed`, each timed beside its plain version
    and the SDPA backward (which computes dQ, dK and dV at once), the pair
    too.  Returns the two kernels' entries of the kernels line (none when
    not timed)."""
    from tdc_video_tpu_torch.ops import flash_attention as fa

    B, T, Hq, Hkv, D = dims
    if packed:
        q, k, v = (rnd(B, T, Hq * D, dtype=dtype).view(B, T, Hq, D) for _ in range(3))
    else:
        q, k, v = rnd(B, T, Hq, D, dtype=dtype), rnd(B, T, Hkv, D, dtype=dtype), \
            rnd(B, T, Hkv, D, dtype=dtype)
    do = rnd(B, T, Hq, D, dtype=dtype)
    o, lse = fa._gqa_fwd(q, k, v, 1.0 / math.sqrt(D), causal)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1).contiguous()[..., None]
    args = q, k, v, do, lse, delta
    scale = 1.0 / math.sqrt(D)
    rtol = ROW_RTOL if dtype == torch.bfloat16 else F32_ATOL
    dq = fa.flash_dq_kernel(*args, scale, causal)
    dk, dv = fa.flash_dkv_kernel(*args, scale, causal)
    dq_r = fa.flash_dq_plain(*args, scale, causal)
    dk_r, dv_r = fa.flash_dkv_plain(*args, scale, causal)
    torch.cuda.synchronize()
    err = {"flash_dq_kernel": _compare_rows(f"flash_dq_kernel dQ {label}", dq, dq_r, rtol),
           "flash_dkv_kernel": max(_compare_rows(f"flash_dkv_kernel dK {label}", dk, dk_r, rtol),
                                   _compare_rows(f"flash_dkv_kernel dV {label}", dv, dv_r, rtol))}
    del dq, dk, dv, dq_r, dk_r, dv_r
    if not timed:
        return []
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, scale=scale,
                                                  enable_gqa=Hq != Hkv)
    fwd_ms = time_ms(sdpa)
    fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), do.transpose(1, 2)))
    lib_ms = fwd_bwd_ms - fwd_ms
    pairs = T * (T + 1) // 2 if causal else T * T
    io = 2.0 * (2 * B * T * Hq * D + 2 * B * T * Hkv * D) + 8.0 * B * Hq * T  # q, dO, k, v, lse, delta
    pair = []
    for name, mult, out_bytes in (("flash_dq_kernel", 6, 2.0 * B * T * Hq * D),
                                  ("flash_dkv_kernel", 8, 4.0 * B * T * Hkv * D)):
        fn = getattr(fa, name)
        ms = time_ms(lambda: fn(*args, scale, causal))
        plain = getattr(fa, name.replace("_kernel", "_plain"))
        plain_ms = time_ms(lambda: plain(*args, scale, causal), reps=2, rounds=3, warmup=1)
        pair.append(_row(name, f"{label} (yardstick: SDPA backward, dQ+dK+dV)",
                         "tdc_video_tpu/ops/flash_attention.py:" + ("433" if name == "flash_dq_kernel" else "489"),
                         err[name], ms, plain_ms, lib_ms, mult * pairs * D * B * Hq, io + out_bytes))
    pair_ms = pair[0]["ms"] + pair[1]["ms"]
    log(f"[2] K5+K6 {label}: {pair_ms:.4f} ms against the SDPA backward's {lib_ms:.4f} ms "
        f"({pair_ms / lib_ms:.2f}x); bound {pair[0]['bound_ms'] + pair[1]['bound_ms']:.4f} ms "
        f"({100 * (pair[0]['bound_ms'] + pair[1]['bound_ms']) / pair_ms:.1f}% of it)")
    for r in pair:
        r.update(pair_ms=pair_ms, pair_vs_library=pair_ms / lib_ms)
    return pair


def phase_train_kernels():
    """K1 at the stage-2 LM shape (T = S = 8192, causal, GQA 24/8, D = 128),
    K4, K5 and K6 against their plain versions and timed.  K4 at both
    tower shapes of the tower-trainable step.  K5 and K6 checked row by row
    at the LM's widths with T=2048, at the stage-2 LM shape, at both tower
    shapes and in small f32 cases, and timed at the stage-2 LM shape and the
    tower shapes, each kernel and the pair K5+K6 beside the SDPA backward
    (which computes dQ, dK and dV at once).  Rows carry the DINOv2 timing of
    K4 and the stage-2 LM timing and error of K1, K5 and K6; the others are
    printed."""
    from tdc_video_tpu_torch.ops import flash_attention as fa

    rnd = _rnd_fn(SEED + 2)
    rows = {"full_attention": k4_row(TOWER_FRAMES)}
    rows["flash_kernel"] = _fwd_row(fa, rnd, "flash_kernel", "tdc_video_tpu/ops/flash_attention.py:38",
                                    (1, TRAIN_T, TRAIN_T, 24, 8, 128), True)
    gc.collect()
    torch.cuda.empty_cache()

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # label, (B, T, Hq, Hkv, D), causal, packed, dtype, timed
        (f"LM T={LM_T_CHECK} causal GQA 24/8", (1, LM_T_CHECK, 24, 8, 128), True, False, bf16, False),
        ("LM f32", (1, 200, 6, 2, 128), True, False, f32, False),
        (f"LM T={TRAIN_T} causal GQA 24/8", (1, TRAIN_T, 24, 8, 128), True, False, bf16, True),
    ]
    for tower, (B, N, H, D) in _towers(TOWER_FRAMES).items():
        cases += [(f"{tower} f32", (2, 145, 4, 4, D), False, True, f32, False),
                  (f"{tower} [{B}, {N}, {H}x{D}]", (B, N, H, H, D), False, True, bf16, True)]
    for label, dims, causal, packed, dtype, timed in cases:
        for r in _bwd_rows(rnd, label, dims, causal, packed, dtype, timed):
            rows.setdefault(r["name"], r)
    log("kernels " + json.dumps({r["name"]: {k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
                                 for r in rows.values()}))
    return list(rows.values())


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


def synth_frames(seed: int, n: int = N_FRAMES) -> np.ndarray:
    """n uint8 frames: a textured background and a bright square that moves
    (its path restarts every 16 frames), with a scene change every 4 frames
    (new background)."""
    rng = np.random.default_rng(seed)
    frames = np.empty((n, FRAME_H, FRAME_W, 3), np.uint8)
    for t in range(n):
        if t % 4 == 0:
            bg = rng.integers(0, 256, (FRAME_H // 8, FRAME_W // 8, 3), dtype=np.uint8)
            bg = np.kron(bg, np.ones((8, 8, 1), np.uint8))
        f = bg.copy()
        y, x = 40 + 15 * (t % 16), 60 + 30 * (t % 16)
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
    # the device preprocessing, which phases 3-5 have always timed (the
    # predictor's default is the host path, which phase 8 times)
    pred = TDCPredictor(cfg, params, ByteTokenizer(), bert_tokenizer=None, device_preprocess=True,
                        device=dev)

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


def phase_flash_vs_xla(cfg, params, pred, frames, tag="4", **audio):
    """LM prefill of one request with attn_impl "flash" and "xla": finite
    logits, the same argmax, max abs difference within LOGIT_ATOL.
    `audio` (wav, frame_seconds) goes to pred.prepare."""
    from tdc_video_tpu_torch.serving.generate import prefill_encoded

    req = pred.prepare(frames, QUESTION, max_new_tokens=MAX_NEW_TOKENS, **audio)
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
    log(f"[{tag}] prefill T={req['gen']['max_len']}: argmax flash {af} xla {ax}, max_abs diff "
        f"{diff:.4e} (tol {LOGIT_ATOL}), xla top-2 gap {float(top2[0] - top2[1]):.4e}")
    if af != ax or diff > LOGIT_ATOL:
        raise AssertionError("flash and xla prefill disagree")


# the port's kernels as torch.profiler names them: the forward template's
# instances by (padded head dim, causal, lse), which tell K1-K4 apart
_FWD_INSTANCE = re.compile(r"flash_fwd_bf16_sm90_kernel<(\d+), (true|false), (true|false)")


def port_kernel(key: str):
    """The library of a profiled kernel of the port (or None): K1 is the
    causal instance, K4 the non-causal one with lse, K2 and K3 the
    non-causal ones without at DP 64 and 80.  The four libraries share one
    template, so the profile's name tells them apart only by these template
    arguments: a non-causal K1 launch (none on the main paths, which run K1
    causal) would be counted under K4."""
    m = _FWD_INSTANCE.search(key)
    if m:
        dp, causal, lse = m.groups()
        if causal == "true":
            return "flash_kernel"
        if lse == "true":
            return "full_attention"
        return "full_attention_nhd" if dp == "64" else "full_attention_nhd_seqq"
    for name in ("flash_dq", "flash_dkv"):
        if f"{name}_bf16_kernel" in key:
            return f"{name}_kernel"
    return None


def profile_stage(tag: str, name: str, fn):
    """torch.profiler over one call of fn: wall time, the device's busy time
    and share, the 8 largest device items by kernel name, and the device
    time of each of the port's kernels.  Returns {library: (device ms,
    launches)} of the port's bf16 wgmma kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    log(f"[{tag}] {name}: wall {wall:.4f} s, device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f}%), {sum(e.count for e in kernels)} device ops")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
    # the port's own kernels, wherever they rank
    ours = [e for e in kernels if e.key.startswith("void tdc::")]
    libs = {}
    for e in sorted(ours, key=lambda e: e.self_device_time_total, reverse=True):
        log(f"[{tag}]   port kernel {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:110]}")
        lib = port_kernel(e.key)
        if lib is not None:
            ms, n = libs.get(lib, (0.0, 0))
            libs[lib] = (ms + e.self_device_time_total / 1e3, n + e.count)
    for lib, (ms, n) in libs.items():
        log(f"[{tag}]   {lib}: {ms:.3f} ms device in {n} launches ({ms / n:.4f} ms each), "
            f"{100 * ms / 1e3 / max(busy, 1e-12):.1f}% of device busy")
    return libs


def phase_profile(pred, frames):
    """torch.profiler over the stages of one more `answer` (encode; compress
    + prefill; compress + prefill + decode); returns each stage's port
    kernels (profile_stage)."""
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
    return {name: profile_stage("5", name, fn) for name, fn in stages}


# ---------------------------------------------------------------------------
# Phase 10
# ---------------------------------------------------------------------------

# drift bounds against float, those of the JAX package's tests/test_quant.py:
# weight-only int8 LM and int8 KV cache logits (test_lm_logits_drift_bounded,
# TestInt8KVCache: max abs difference over max abs logit); the act-quant
# prefill's logits against the float LM's on the same inputs
# (TestInt8ActQuantPrefill); the int8 towers' encode_frames features
# against the float towers' (test_encode_compress_int8_drift: norm of the
# difference over the norm)
INT8_REL = 0.05
ACT_QUANT_REL = 0.08
ENCODE_INT8_REL = 0.08
# a speculative answer may part from the plain one only on a near tie
SPEC_TIE_GAP = 1e-2
SPEC_WINDOW = 8


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def _answer(pred, frames, tag):
    """One warm answer with the launch counters set to 0 just before and
    read just after: (ids, stats, launches, peak GiB, wall s)."""
    from tdc_video_tpu_torch.ops import flash_attention as fa

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    pred.answer(frames, QUESTION, max_new_tokens=MAX_NEW_TOKENS)
    wall = time.perf_counter() - t0
    counts = dict(fa.launches)
    st = dataclasses.replace(pred.stats, last_ids=list(pred.stats.last_ids))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[10] {tag} answer: wall {wall:.3f} s: encode {st.encode_s:.3f} s, compress+prefill "
        f"{st.prefill_s:.3f} s, decode {st.decode_s:.3f} s ({st.decode_steps} steps); peak "
        f"{peak:.2f} GiB; launches {json.dumps(counts)}; ids {st.last_ids}")
    return st.last_ids, st, counts, peak, wall


def _leg(phase: int, name: str, **numbers):
    """One JSON line per leg, its numbers beside the card."""
    log(json.dumps({"phase": phase, "leg": name, **numbers, "card": card()}))


def _decode_step_ms(cfg, params, gen, **kw) -> float:
    """Device ms of one decode step after this request's prefill (a cache
    with room for the timed steps)."""
    from tdc_video_tpu_torch.models import lm as lm_mod
    from tdc_video_tpu_torch.serving.generate import prefill_encoded

    logits, cache = prefill_encoded(cfg, params, **dict(gen, max_new_tokens=256), attn_impl="flash",
                                    **kw)
    emb = lm_mod.embed_tokens(cfg.lm, params["lm"], logits.argmax(-1)[:, None], cfg.dtype)
    return time_ms(lambda: lm_mod.decode_step(cfg.lm, params["lm"], emb, cache, attn_impl="flash",
                                              dtype=cfg.dtype), reps=20, rounds=5)


def _gap_at(cfg, params, logits, cache, ids, p, sampling=None):
    """Top-2 gap at position p of the stream `ids`, fed from (logits,
    cache) of its prefill: of the raw logits when greedy; of the filtered
    and gumbel-perturbed logits of token p's key when sampled."""
    from tdc_video_tpu_torch.models import lm as lm_mod
    from tdc_video_tpu_torch.serving import generate as gen_mod
    from tdc_video_tpu_torch.serving import prng

    for tok in ids[:p]:
        emb = lm_mod.embed_tokens(cfg.lm, params["lm"], torch.tensor([[tok]], device=DEVICE),
                                  cfg.dtype)
        logits, cache = lm_mod.decode_step(cfg.lm, params["lm"], emb, cache, attn_impl="flash",
                                           dtype=cfg.dtype)
    x = logits[0].float()
    if sampling:
        one = lambda v, dt: torch.tensor([v], dtype=dt, device=DEVICE)  # noqa: E731
        x = gen_mod.filter_rows(logits.float(), one(sampling["temperature"], torch.float32),
                                one(sampling["top_k"], torch.int32),
                                one(sampling["top_p"], torch.float32))
        key = gen_mod.row_keys(one(sampling["seed"], torch.int32), one(p, torch.int32))
        x = (x + prng.gumbel(key, (x.shape[-1],)))[0]
    top2 = torch.topk(x, 2).values
    return float(top2[0] - top2[1])


def _first_part(a, b):
    """The first position where two token lists differ, or None."""
    if a == b:
        return None
    return next(i for i in range(max(len(a), len(b)))
                if i >= len(a) or i >= len(b) or a[i] != b[i])


def _first_difference_gap(cfg, params, gen, ids, other):
    """Where two answers first part: (position, top-2 gap of the plain run's
    logits there), the logits recomputed by feeding the plain ids."""
    from tdc_video_tpu_torch.serving.generate import prefill_encoded

    p = _first_part(ids, other)
    logits, cache = prefill_encoded(cfg, params, **gen, attn_impl="flash")
    return p, _gap_at(cfg, params, logits, cache, ids, p)


def phase_serving_options(cfg, params, pred, frames, ids):
    """Phase 10: the demo's serving options on phase 3's TDC-Llama3.2-3B
    and request: (a) int8 LM, (b) int8 LM and towers with static scales and
    act-quant prefill, (c) int8 KV cache, (d) speculative decoding, (e) a
    torch.profiler trace of one answer.  Returns each leg's launch counts."""
    from tdc_video_tpu_torch.data.images import device_preprocess
    from tdc_video_tpu_torch.eval.runner import TDCPredictor
    from tdc_video_tpu_torch.models import lm as lm_mod
    from tdc_video_tpu_torch.models.quant import (
        calibrate_vit_act_scales,
        quantize_lm_int8,
        quantize_vit_int8,
    )
    from tdc_video_tpu_torch.serving.generate import prefill_encoded
    from tdc_video_tpu_torch.utils.profiling import trace

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)

    def predictor(p, **kw):
        return TDCPredictor(cfg, p, ByteTokenizer(), bert_tokenizer=None, device_preprocess=True,
                            device=dev, **kw)

    gen = pred.prepare(frames, QUESTION, max_new_tokens=MAX_NEW_TOKENS)["gen"]
    ref_logits = prefill_encoded(cfg, params, **gen, attn_impl="flash")[0].float()
    bf16_ids, bf16_st, _, bf16_peak, _ = _answer(pred, frames, "bf16")
    if bf16_ids != ids:
        raise AssertionError(f"[10] the bf16 answer differs from phase 3's: {bf16_ids} vs {ids}")
    bf16_step_ms = _decode_step_ms(cfg, params, gen)
    hidden = torch.randn((1, 1, cfg.lm.hidden_size), device=dev).to(cfg.dtype)
    counts = {}

    # (a) weight-only int8 LM
    t0 = time.perf_counter()
    qparams = dict(params, lm=quantize_lm_int8(params["lm"]))
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    qpred = predictor(qparams)
    q_logits = prefill_encoded(cfg, qparams, **gen, attn_impl="flash")[0].float()
    rel = _rel(q_logits, ref_logits)
    q_ids, q_st, counts["int8"], q_peak, _ = _answer(qpred, frames, "int8 LM")
    agree = sum(a == b for a, b in zip(q_ids, ids)) / max(len(ids), 1)
    head = {k: time_ms(lambda: lm_mod.lm_head(cfg.lm, p["lm"], hidden), reps=5, rounds=3)
            for k, p in (("int8", qparams), ("bf16", params))}
    step = {"int8": _decode_step_ms(cfg, qparams, gen), "bf16": bf16_step_ms}
    _leg(10, "a_int8", quantize_s=quant_s, prefill_rel=rel, prefill_rel_bound=INT8_REL,
         prefill_argmax_same=bool(q_logits.argmax(-1).item() == ref_logits.argmax(-1).item()),
         answer_agreement=agree,
         decode_ms_per_token={"int8": 1e3 * q_st.decode_s / max(q_st.decode_steps, 1),
                              "bf16": 1e3 * bf16_st.decode_s / max(bf16_st.decode_steps, 1)},
         decode_step_device_ms=step,
         lm_head_ms=dict(head, tied=cfg.lm.tie_word_embeddings),
         peak_gib={"int8": q_peak, "bf16": bf16_peak})
    if not rel < INT8_REL or not torch.isfinite(q_logits).all():
        raise AssertionError(f"[10a] int8 prefill logits rel {rel:.4e} (bound {INT8_REL})")

    # (b) int8 LM and towers, static scales from the request's own frames,
    # act-quant prefill
    t0 = time.perf_counter()
    sig, dino = device_preprocess(torch.from_numpy(frames).to(dev), cfg)
    scales = {t: calibrate_vit_act_scales(getattr(cfg, t), params[t], px.to(cfg.dtype),
                                          dtype=cfg.dtype)
              for t, px in (("siglip", sig), ("dino", dino))}
    del sig, dino
    aparams = dict(qparams, **{t: quantize_vit_int8(params[t], act_scales=scales[t])
                               for t in scales})
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    apred = predictor(aparams, act_quant=True)
    a_gen = apred.prepare(frames, QUESTION, max_new_tokens=MAX_NEW_TOKENS)["gen"]
    a_logits = prefill_encoded(cfg, aparams, **a_gen, attn_impl="flash",
                               act_quant=True)[0].float()
    # the LM's drift on its own inputs (the int8 towers' request), and the
    # towers' drift on the encode features, each against float
    lm_ref = prefill_encoded(cfg, dict(aparams, lm=params["lm"]), **a_gen,
                             attn_impl="flash")[0].float()
    rel_lm = _rel(a_logits, lm_ref)

    def nrel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    enc = {"frame_feats": nrel(a_gen["frame_feats"], gen["frame_feats"]),
           "dino_feats": nrel(a_gen["dino_feats"], gen["dino_feats"])}
    a_ids, a_st, counts["int8_all"], a_peak, _ = _answer(apred, frames, "int8-all")
    _leg(10, "b_int8_all", calibrate_and_quantize_s=calib_s, act_quant_prefill_rel=rel_lm,
         act_quant_prefill_rel_bound=ACT_QUANT_REL, encode_feature_rel=enc,
         encode_feature_rel_bound=ENCODE_INT8_REL,
         end_to_end_prefill_rel=_rel(a_logits, ref_logits),
         prefill_argmax_same=bool(a_logits.argmax(-1).item() == ref_logits.argmax(-1).item()),
         answer_agreement=sum(a == b for a, b in zip(a_ids, ids)) / max(len(ids), 1),
         encode_s={"int8": a_st.encode_s, "bf16": bf16_st.encode_s},
         prefill_s={"int8_act_quant": a_st.prefill_s, "bf16": bf16_st.prefill_s},
         launches=counts["int8_all"], peak_gib=a_peak)
    if not rel_lm < ACT_QUANT_REL or not torch.isfinite(a_logits).all():
        raise AssertionError(f"[10b] act-quant prefill logits rel {rel_lm:.4e} "
                             f"(bound {ACT_QUANT_REL})")
    if not enc["frame_feats"] < ENCODE_INT8_REL:
        raise AssertionError(f"[10b] int8 towers' encode features rel {enc['frame_feats']:.4e} "
                             f"(bound {ENCODE_INT8_REL})")
    if counts["int8_all"]["full_attention_nhd"] <= 0 or \
            counts["int8_all"]["full_attention_nhd_seqq"] <= 0:
        raise AssertionError("[10b] K2 and K3 were not launched in the int8 towers")
    del qpred, apred, aparams, qparams, a_gen
    gc.collect()
    torch.cuda.empty_cache()

    # (c) int8 KV cache: the prefill attends the fresh bf16 keys (K1), the
    # first decode step reads the quantized cache back
    kv = {}
    for name, quant in (("int8", "int8"), ("bf16", None)):
        lg, cache = prefill_encoded(cfg, params, **gen, attn_impl="flash", kv_quant=quant)
        emb = lm_mod.embed_tokens(cfg.lm, params["lm"], lg.argmax(-1)[:, None], cfg.dtype)
        kv[name] = (lg.float(), lm_mod.decode_step(cfg.lm, params["lm"], emb, cache,
                                                   attn_impl="flash", dtype=cfg.dtype)[0].float())
        del cache
    rel_kv, rel_kv_step = _rel(kv["int8"][0], kv["bf16"][0]), _rel(kv["int8"][1], kv["bf16"][1])
    kvpred = predictor(params, kv_quant="int8")
    kv_ids, kv_st, counts["kv_int8"], kv_peak, _ = _answer(kvpred, frames, "int8 KV")
    _leg(10, "c_kv_int8", prefill_rel=rel_kv, first_decode_step_rel=rel_kv_step,
         prefill_rel_bound=INT8_REL,
         answer_agreement=sum(a == b for a, b in zip(kv_ids, ids)) / max(len(ids), 1),
         decode_ms_per_token={"int8_kv": 1e3 * kv_st.decode_s / max(kv_st.decode_steps, 1),
                              "bf16": 1e3 * bf16_st.decode_s / max(bf16_st.decode_steps, 1)},
         decode_step_device_ms={"int8_kv": _decode_step_ms(cfg, params, gen, kv_quant="int8"),
                                "bf16": bf16_step_ms},
         launches=counts["kv_int8"], peak_gib=kv_peak)
    if not rel_kv < INT8_REL or not rel_kv_step < INT8_REL:
        raise AssertionError(f"[10c] int8 KV logits rel {rel_kv:.4e} / {rel_kv_step:.4e} "
                             f"(bound {INT8_REL})")
    if counts["kv_int8"]["flash_kernel"] <= 0:
        raise AssertionError("[10c] K1 was not launched over the int8 cache's prefill")

    # (d) prompt-lookup speculative decoding, window 8
    spred = predictor(params, spec_window=SPEC_WINDOW)
    s_ids, s_st, counts["spec"], _, _ = _answer(spred, frames, f"spec_window={SPEC_WINDOW}")
    tie = None
    if s_ids != ids:
        tie = _first_difference_gap(cfg, params, gen, ids, s_ids)
        log(f"[10] the speculative answer parts from the plain one at position {tie[0]}, where "
            f"the plain run's top-2 logit gap is {tie[1]:.4e} (near tie below {SPEC_TIE_GAP})")
    _leg(10, "d_spec", window=SPEC_WINDOW, identical=s_ids == ids, first_difference=tie,
         verify_steps=s_st.decode_steps,
         tokens_after_first_per_verify_step=(len(s_ids) - 1) / max(s_st.decode_steps, 1),
         decode_s={"spec": s_st.decode_s, "plain": bf16_st.decode_s},
         plain_decode_steps=bf16_st.decode_steps)
    if tie is not None and not tie[1] < SPEC_TIE_GAP:
        raise AssertionError(f"[10d] the speculative answer differs off a near tie: {s_ids}")

    # (e) a torch.profiler trace around one answer names K1's launch
    with tempfile.TemporaryDirectory() as logdir:
        with trace(logdir):
            pred.answer(frames, QUESTION, max_new_tokens=MAX_NEW_TOKENS)
        path = os.path.join(logdir, "trace.json")
        size = os.path.getsize(path)
        with open(path) as fh:
            names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    k1 = sorted(n for n in names if port_kernel(n) == "flash_kernel")
    _leg(10, "e_trace", trace_bytes=size, events_named=len(names), k1_names=k1[:2])
    if not k1:
        raise AssertionError("[10e] the trace names no K1 launch")
    log(f"[10] phase 10 in {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# Phase 12
# ---------------------------------------------------------------------------

# phase 3's question and three of other lengths, about the same video
SERVE_QUESTIONS = (QUESTION, "Describe the square.",
                   "What colour is the background at the start of the clip?",
                   "How many times does the background change, and where is the bright square "
                   "when it does? Answer in one sentence.")
SERVE_SLOTS = 4
SERVE_CHUNK = 512  # leg (b): prefill_chunk
# leg (c), as the reference demo samples (main.py:64-65: do_sample,
# temperature 0.2, HF's default top_k 50), seed 0
SERVE_SAMPLING = {"temperature": 0.2, "top_k": 50, "top_p": 1.0, "seed": 0}
CHAT_QUESTIONS = (QUESTION, "What colour is the square?", "Does the background change?")


def _trimmed(cfg, ids):
    from tdc_video_tpu_torch.eval.runner import _trim_generated

    return _trim_generated(ids, cfg.lm)


def _hold_tokens(tag, cfg, params, got, want, prefill, sampling=None):
    """got equal to want, or parting first on a near tie of want's own run:
    a top-2 gap under SPEC_TIE_GAP (over the temperature for sampled rows,
    whose logits it divides).  `prefill()` gives want's (logits, cache).
    Returns None or (position, gap)."""
    p = _first_part(got, want)
    if p is None:
        return None
    logits, cache = prefill()
    gap = _gap_at(cfg, params, logits, cache, want, p, sampling)
    bound = SPEC_TIE_GAP / (sampling["temperature"] if sampling else 1.0)
    log(f"[12] {tag}: parts at position {p} where the reference's top-2 gap is {gap:.4e} "
        f"(near tie below {bound:.1e})")
    if not gap < bound:
        raise AssertionError(f"[12] {tag}: {got} differs from {want} off a near tie")
    return p, gap


def _serve_run(pred, frames, uid, **kw):
    """One answer_many with the launch counters set to 0 just before and
    read just after; returns (raw ids per question, engine, wall s, time to
    each first token s, launches)."""
    from tdc_video_tpu_torch.ops import flash_attention as fa

    first_t = {}

    def on_tokens(req, new):
        first_t.setdefault(req.uid, time.perf_counter())

    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    pred.answer_many(frames, SERVE_QUESTIONS, max_new_tokens=MAX_NEW_TOKENS, video_uid=uid,
                     on_tokens=on_tokens, **kw)
    wall = time.perf_counter() - t0
    counts = dict(fa.launches)
    eng = next(reversed(pred._engine_cache.values()))
    ttft = [first_t[i] - t0 for i in range(len(SERVE_QUESTIONS))]
    return [list(x) for x in pred.stats.last_many_ids], eng, wall, ttft, counts


def _decode_rate(eng) -> float:
    """Steady decode tokens/s: harvested tokens over the decode chunks'
    own seconds (admission and prefill between chunks excluded)."""
    return sum(n for _, _, n in eng.chunk_spans) / max(sum(b - a for a, b, _ in eng.chunk_spans),
                                                        1e-9)


def phase_multi_serving(cfg, params, pred, frames):
    """Phase 12: several questions about one video through answer_many and
    ChatSession on phase 3's model (module docstring).  Returns the launch
    counts of legs (a) and (e)."""
    from tdc_video_tpu_torch.eval.runner import TDCPredictor
    from tdc_video_tpu_torch.models import lm as lm_mod
    from tdc_video_tpu_torch.ops import flash_attention as fa
    from tdc_video_tpu_torch.serving import generate as gen_mod
    from tdc_video_tpu_torch.serving import session as sess_mod
    from tdc_video_tpu_torch.serving.batching import DecodeEngine, Request
    from tdc_video_tpu_torch.serving.generate import prefill_encoded

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    n_q = len(SERVE_QUESTIONS)
    # solo answers, one question each (the feature cache warm after the first)
    solo, solo_s, gens = [], [], []
    for q in SERVE_QUESTIONS:
        t0 = time.perf_counter()
        pred.answer(frames, q, max_new_tokens=MAX_NEW_TOKENS, video_uid="p12-solo")
        solo_s.append(time.perf_counter() - t0)
        solo.append(list(pred.stats.last_ids))
        gens.append(pred.prepare(frames, q, max_new_tokens=MAX_NEW_TOKENS,
                                 video_uid="p12-solo")["gen"])

    def solo_prefill(i):
        return lambda: prefill_encoded(cfg, params, **gens[i], attn_impl="flash")

    def hold_all(tag, got, want=solo, sampling=None):
        return [_hold_tokens(f"{tag} q{i}", cfg, params, _trimmed(cfg, g), _trimmed(cfg, w),
                             solo_prefill(i), sampling) for i, (g, w) in
                enumerate(zip(got, want))]

    # (a) greedy, 4 slots: a first run pays the allocator's growth; the
    # second (a video uid not yet cached: the towers run once) is measured
    _serve_run(pred, frames, "p12-warm", num_slots=SERVE_SLOTS)
    ids_a, eng, wall, ttft, counts_a = _serve_run(pred, frames, "p12-a", num_slots=SERVE_SLOTS)
    ties_a = hold_all("(a)", ids_a)
    rate4 = _decode_rate(eng)
    # the packed prompts (features cached) and the prefix answer_many shared
    packed = [pred.pack_prompt(frames, q, video_uid="p12-a") for q in SERVE_QUESTIONS]
    p_len = pred._shared_prefix_len([(e, m.cpu().numpy(), i) for e, m, i in packed])
    steps_a, prefix_prefills = eng.steps, eng.prefix_prefills
    # K1 runs only in the one prefix prefill (a causal T >= 128 forward,
    # each LM layer); the suffix extends and the decode steps take sdpa;
    # the towers run once (every DINOv2 and SigLIP layer)
    expected = {"flash_kernel": cfg.lm.num_layers, "full_attention_nhd": cfg.dino.num_layers,
                "full_attention_nhd_seqq": cfg.siglip.num_layers, "full_attention": 0,
                "flash_dq_kernel": 0, "flash_dkv_kernel": 0}
    ids_1, eng1, wall1, ttft1, _ = _serve_run(pred, frames, "p12-a", num_slots=1)
    rate1 = _decode_rate(eng1)
    ties_1 = hold_all("(a, 1 slot)", ids_1)
    _leg(12, "a_answer_many", slots=SERVE_SLOTS, questions=n_q, new_tokens=MAX_NEW_TOKENS,
           wall_s=wall, solo_answers_s=solo_s, solo_sum_s=sum(solo_s),
           time_to_first_token_s=ttft, decode_tokens_per_s={"4_slots": rate4, "1_slot": rate1},
           wall_1_slot_s=wall1, time_to_first_token_1_slot_s=ttft1, decode_chunks=steps_a,
           shared_prefix_len=p_len, prompt_rows=[int(m.sum()) for _, m, _ in packed],
           prefix_prefills=prefix_prefills, launches=counts_a, launches_expected=expected,
           near_ties=ties_a, near_ties_1_slot=ties_1, ids=ids_a)
    if prefix_prefills != 1:
        raise AssertionError(f"[12a] {prefix_prefills} prefix prefills, not 1")
    if counts_a != expected:
        raise AssertionError(f"[12a] launches {counts_a}, expected {expected}")

    # (b) chunked admission, 512 tokens a chunk
    ids_b, eng_b, wall_b, ttft_b, _ = _serve_run(pred, frames, "p12-a", num_slots=SERVE_SLOTS,
                                                 prefill_chunk=SERVE_CHUNK)
    gaps = [b - a for a, b in zip(eng_b.chunk_times, eng_b.chunk_times[1:])]
    ties_b = hold_all("(b)", ids_b, ids_a)
    _leg(12, "b_chunked_admission", prefill_chunk=SERVE_CHUNK, wall_s=wall_b,
           prefill_chunks=eng_b.prefill_chunks, largest_gap_between_chunks_s=max(gaps, default=0.0),
           time_to_first_token_s=ttft_b, near_ties=ties_b)
    if eng_b.prefill_chunks < 2:
        raise AssertionError(f"[12b] {eng_b.prefill_chunks} prefill chunks")

    # (c) sampled, as the reference demo samples
    runs = [_serve_run(pred, frames, "p12-a", num_slots=SERVE_SLOTS, **SERVE_SAMPLING)[0]
            for _ in range(2)]
    if runs[0] != runs[1]:
        raise AssertionError(f"[12c] two sampled runs differ: {runs}")
    ids_c1 = _serve_run(pred, frames, "p12-a", num_slots=1, **SERVE_SAMPLING)[0]
    ties_c = []
    for i, (g, w) in enumerate(zip(ids_c1, runs[0])):
        # the reference of the tie test: this request's 1-slot stream, from
        # a solo prefill, each token keyed on (seed + i, index)
        ties_c.append(_hold_tokens(f"(c) 1 vs 4 slots q{i}", cfg, params, _trimmed(cfg, w),
                                   _trimmed(cfg, g), solo_prefill(i),
                                   dict(SERVE_SAMPLING, seed=SERVE_SAMPLING["seed"] + i)))
    # a mixed batch: questions 1 and 3 sampled, 0 and 2 greedy, in one engine
    cap = int(np.ceil((max(e.shape[1] for e, _, _ in packed) + MAX_NEW_TOKENS) / 128) * 128)
    eng_m = DecodeEngine(cfg, params, num_slots=SERVE_SLOTS, capacity=cap, attn_impl="flash",
                         device=dev)
    for i, (e, m, pids) in enumerate(packed):
        s = dict(SERVE_SAMPLING, seed=SERVE_SAMPLING["seed"] + i) if i % 2 else {}
        eng_m.submit(Request(embeds=e, attn_mask=m.cpu().numpy(), max_new_tokens=MAX_NEW_TOKENS,
                             uid=i, prompt_ids=pids, prefix_key="video", prefix_len=p_len, **s))
    by_uid = {r.uid: list(r.tokens) for r in eng_m.run()}
    for i in (0, 2):
        if by_uid[i] != ids_a[i]:
            raise AssertionError(f"[12c] greedy row {i} of the mixed batch {by_uid[i]} differs "
                                 f"from (a)'s {ids_a[i]}")
    for i in (1, 3):
        if by_uid[i] != runs[0][i]:
            raise AssertionError(f"[12c] sampled row {i} of the mixed batch differs from the "
                                 "all-sampled run's")
    # sample_rows on the card and on the host CPU, on the prefill logits
    logits = torch.cat([prefill_encoded(cfg, params, **g, attn_impl="flash")[0] for g in gens])
    rows = (torch.full((n_q,), SERVE_SAMPLING["temperature"]),
            torch.full((n_q,), SERVE_SAMPLING["top_k"], dtype=torch.int32),
            torch.full((n_q,), SERVE_SAMPLING["top_p"]),
            torch.arange(n_q, dtype=torch.int32), torch.zeros(n_q, dtype=torch.int32))
    on_card = gen_mod.sample_rows(logits, *(r.to(dev) for r in rows)).cpu()
    on_host = gen_mod.sample_rows(logits.cpu(), *rows)
    t_rows = time_ms(lambda: gen_mod.sample_rows(logits, *(r.to(dev) for r in rows)), reps=5,
                     rounds=3)
    _leg(12, "c_sampled", sampling=SERVE_SAMPLING, ids=runs[0], two_runs_identical=True,
           near_ties_1_vs_4_slots=ties_c, mixed_greedy_rows_identical=True,
           sample_rows_card=on_card.tolist(), sample_rows_host=on_host.tolist(),
           sample_rows_ms_4_rows=t_rows)
    if not torch.equal(on_card, on_host):
        raise AssertionError(f"[12c] sample_rows on the card {on_card} vs the host {on_host}")

    # (d) speculative lockstep, window 8
    spred = TDCPredictor(cfg, params, ByteTokenizer(), bert_tokenizer=None,
                         device_preprocess=True, device=dev, spec_window=SPEC_WINDOW)
    ids_d, eng_d, wall_d, _, _ = _serve_run(spred, frames, "p12-d", num_slots=SERVE_SLOTS)
    ties_d = hold_all("(d)", ids_d, ids_a)
    _leg(12, "d_spec", window=SPEC_WINDOW, wall_s=wall_d, verify_steps=eng_d.steps * eng_d.chunk_tokens,
           decode_chunks=eng_d.steps, tokens=sum(len(x) for x in ids_d), near_ties=ties_d)
    del spred, eng_d

    # (e) a 3-turn conversation
    fa.reset_launches()
    sess = pred.chat(frames, video_uid="p12-e", max_new_tokens=MAX_NEW_TOKENS)
    walls, lens, counts_e = [], [], {}
    for i, q in enumerate(CHAT_QUESTIONS):
        if i == 1:
            counts_e = dict(fa.launches)
            fa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.ask(q)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        lens.append(sess._kv_len)
    later = dict(fa.launches)
    t1, t2 = sess.turn_tokens[:2]
    # turn 2 from scratch: one request over [turn-1 prompt | turn-1 tokens |
    # glue + question 2], prefilled in one shot
    emb1, mask1, _ = pred.pack_prompt(frames, CHAT_QUESTIONS[0], video_uid="p12-e")
    valid1 = int(mask1.sum())
    glue = sess_mod.encode_plain(pred.tok, sess_mod.follow_up_text(
        cfg, CHAT_QUESTIONS[1], t1[-1] in cfg.lm.eos_token_ids))
    seq = torch.tensor([list(t1) + list(glue)], device=dev)
    full = torch.cat([emb1[:, :valid1], lm_mod.embed_tokens(cfg.lm, params["lm"], seq, cfg.dtype)],
                     dim=1)
    L = full.shape[1]
    eng_s = DecodeEngine(cfg, params, num_slots=1, capacity=L + MAX_NEW_TOKENS, attn_impl="flash",
                         device=dev)
    eng_s.submit(Request(embeds=full, attn_mask=np.ones((1, L), bool),
                         max_new_tokens=MAX_NEW_TOKENS, uid=0))
    (r,) = eng_s.run()

    def scratch_prefill():
        cache = lm_mod.init_kv_cache(cfg.lm, 1, L + MAX_NEW_TOKENS, cfg.dtype, device=dev)
        return lm_mod.prefill(cfg.lm, params["lm"], full, torch.ones((1, L), dtype=torch.bool,
                                                                     device=dev),
                              cache, attn_impl="flash", dtype=cfg.dtype)

    tie_e = _hold_tokens("(e) turn 2 vs from scratch", cfg, params, _trimmed(cfg, t2),
                         _trimmed(cfg, list(r.tokens)), scratch_prefill)
    sess.close()
    counts_chat = {k: counts_e.get(k, 0) + later[k] for k in later}
    _leg(12, "e_chat", turns=len(CHAT_QUESTIONS), turn_wall_s=walls, kv_len=lens,
           launches_turn_1=counts_e, launches_turns_2_3=later, turn2_vs_scratch_tie=tie_e,
           turn_tokens=sess.turn_tokens, prefix_prefills=sess._engine.prefix_prefills)
    if not lens[0] < lens[1] < lens[2]:
        raise AssertionError(f"[12e] kv_len does not grow: {lens}")
    if later["full_attention_nhd"] or later["full_attention_nhd_seqq"]:
        raise AssertionError(f"[12e] turns 2-3 ran the towers: {later}")
    log(f"[12] phase 12 in {time.perf_counter() - t_phase:.1f} s")
    return counts_a, counts_chat


# ---------------------------------------------------------------------------
# Phases 6-7
# ---------------------------------------------------------------------------

TRAIN_QUESTION = "Describe what happens in this video, scene by scene."
TRAIN_SCENES = ("a textured background of coloured tiles fills the frame",
                "a bright white square enters from the upper left",
                "the square moves steadily down and to the right",
                "the background changes to a new pattern every four seconds")


def train_conversation():
    """A three-turn Llama-3 conversation about the clip: about 2,000 bytes
    (the byte-level tokenizer's token count), so that with the visual
    tokens the spliced sequence fills most of the 8192 rows."""
    answer = " ".join(f"In scene {i + 1}, {TRAIN_SCENES[i % 4]}, and the camera holds still "
                      f"while the light stays even across the whole frame." for i in range(12))
    return [
        {"from": "human", "value": "<image>\n" + TRAIN_QUESTION},
        {"from": "gpt", "value": answer},
        {"from": "human", "value": "How many times does the background change?"},
        {"from": "gpt", "value": "It changes " + ", then ".join(["once more"] * 15) + "."},
        {"from": "human", "value": "What colour is the square?"},
        {"from": "gpt", "value": "The square is bright white throughout the clip."},
    ]


def train_batch(cfg, n_frames: int, tok=None):
    """One stage-2 sample as the JAX trainer's batch dict of numpy arrays:
    preprocess/pack_text labels (assistant turns only), n_frames synthetic
    frames through the device-side preprocessing, the Q-Former prompt ids,
    and the aspect layout of 360x640 frames.  `tok`: the byte-level
    tokenizer of the config's LM (Llama-3's by default)."""
    from tdc_video_tpu_torch.compress.aspect import frame_token_layout
    from tdc_video_tpu_torch.data.images import device_preprocess
    from tdc_video_tpu_torch.data.preprocess import pack_text, preprocess

    tok = tok or ByteTokenizer()
    out = preprocess([train_conversation()], tok, cfg.conv_version, has_image=True)
    packed = pack_text(out["input_ids"], out["labels"], TRAIN_TEXT_LEN, cfg.lm.pad_token_id)
    qids = np.zeros((1, 64), np.int32)
    enc = tok.encode(" ".join(out["prompts"]))[:64]
    qids[0, :len(enc)] = enc
    frames = synth_frames(SEED + 1, n_frames)
    sig, dino = device_preprocess(torch.from_numpy(frames).to(DEVICE), cfg)
    tv, qp = frame_token_layout(cfg, FRAME_H, FRAME_W)
    return {
        "input_ids": packed["input_ids"], "labels": packed["labels"],
        "image_pos": packed["image_pos"], "text_len": packed["text_len"],
        "has_image": packed["has_image"],
        "siglip_px": sig[None].cpu().numpy(), "dino_px": dino[None].cpu().numpy(),
        "frame_mask": np.ones((1, n_frames), bool),
        "qformer_text_ids": qids, "qformer_text_mask": qids > 0,
        "token_valid": tv[None], "query_pool": qp[None],
    }


def _named_leaves(params):
    from tdc_video_tpu_torch.train.step import tree_map_with_path

    out = {}
    tree_map_with_path(lambda path, t: out.__setitem__("/".join(path), t), params)
    return out


def _micro_steps(trainer, batch, n: int, expected: dict, tag: str):
    """n calls of train_step, each with the launch counters set to 0 just
    before and read just after; returns (losses, walls, last counts)."""
    from tdc_video_tpu_torch.ops import flash_attention as fa

    losses, walls = [], []
    for i in range(n):
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        loss = float(trainer.train_step(batch))  # waits for the step
        walls.append(time.perf_counter() - t0)
        counts = dict(fa.launches)
        losses.append(loss)
        log(f"[{tag}] micro-step {i + 1}: loss {loss:.6f}, wall {walls[-1]:.3f} s, "
            f"optimizer updates {trainer.tx.count}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB, launches {json.dumps(counts)}")
        if not math.isfinite(loss):
            raise AssertionError("non-finite training loss")
        if counts != expected:
            raise AssertionError(f"launches {counts}, expected {expected}")
    return losses, walls, counts


def _check_changes(tag, params, snap, must_change, must_keep, zero_grad):
    """Leaves under `must_change` differ from the snapshot unless their
    gradient was all zero; leaves under `must_keep` are bitwise equal."""
    unchanged, moved_frozen = [], []
    for name, t in _named_leaves(params).items():
        same = torch.equal(t.detach().cpu(), snap[name])
        if name.split("/")[0] in must_keep and not same:
            moved_frozen.append(name)
        if name.split("/")[0] in must_change and same:
            unchanged.append(name)
    stuck = [n for n in unchanged if n not in zero_grad]
    log(f"[{tag}] unchanged trainable leaves (all-zero gradient): {unchanged}")
    if stuck or moved_frozen:
        raise AssertionError(f"trainable leaves that did not change: {stuck}; "
                             f"frozen leaves that changed: {moved_frozen}")
    log(f"[{tag}] every trainable leaf with a gradient changed; {sorted(must_keep)} bitwise unchanged")


def _cosine(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a * b).sum() / ((a * a).sum() * (b * b).sum()).sqrt().clamp_min(1e-300))


def phase_train(cfg):
    """Stage-2 video SFT at full width and depth: flash vs xla loss and LM
    gradients, then 2 optimizer steps.  Returns (params, counts of K5/K6 per
    micro-step)."""
    from tdc_video_tpu_torch.model import init_tdc, tdc_loss
    from tdc_video_tpu_torch.train.stages import stage2_video_sft
    from tdc_video_tpu_torch.train.step import train_view
    from tdc_video_tpu_torch.train.trainer import Trainer

    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    params = init_tdc(cfg, torch.Generator(device=dev).manual_seed(SEED), dev, torch.float32)
    torch.cuda.synchronize()
    log(f"[6] init_tdc f32 in {time.perf_counter() - t0:.1f} s")
    tcfg = dataclasses.replace(stage2_video_sft(), max_steps=2, report_to="none")
    assert tcfg.model_max_length == TRAIN_T
    batch = train_batch(cfg, TRAIN_FRAMES)
    n_text = int(batch["text_len"][0])
    n_lab = int((batch["labels"] >= 0).sum())
    log(f"[6] sample: {TRAIN_FRAMES} frames, {n_text} text tokens ({n_lab} labelled), LM rows "
        f"{tcfg.model_max_length}, max_visual_len {tcfg.max_visual_len}, loss_chunk {tcfg.loss_chunk}")
    trainer = Trainer(cfg, tcfg, params, total_steps=tcfg.max_steps, device=dev)
    n_train = sum(t.numel() for t in trainer.tx.params)
    log(f"[6] trainable {n_train / 1e9:.3f} B params (LM, SVA, compressor, image_newline); "
        f"towers frozen")

    # one loss-and-gradient pass per attention path, before the optimizer state exists
    b = _to_dev(cfg, batch)
    # the spliced sequence's non-pad rows (text less the <image> slot, plus
    # the visual tokens), for the tokens/s of real tokens
    n_real = _non_pad_rows(cfg, tcfg, params, b)
    n_vis = n_real - (n_text - 1)
    log(f"[6] spliced sequence: {n_real} non-pad rows of {tcfg.model_max_length} "
        f"({n_text - 1} text + {n_vis} visual tokens)")
    view = train_view(params)
    lm_leaves = {n: t for n, t in _named_leaves(params).items() if n.startswith("lm/")}
    losses, flash_grads, zero_grad = {}, {}, set()
    for impl in ("flash", "xla"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tdc_loss(cfg, view, b, max_len=tcfg.model_max_length,
                        max_visual_len=tcfg.max_visual_len, attn_impl=impl, remat=True,
                        loss_chunk=tcfg.loss_chunk)
        loss.backward()
        losses[impl] = float(loss.detach())
        log(f"[6] {impl}: loss {losses[impl]:.6f}, loss+grads {time.perf_counter() - t0:.3f} s, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if impl == "flash":
            flash_grads = {n: t.grad.cpu() for n, t in lm_leaves.items()}
            zero_grad = {n for n, t in _named_leaves(params).items()
                         if t.requires_grad and not bool(t.grad.any())}
        else:
            dot = nf = nx = 0.0
            for n, t in lm_leaves.items():
                gf = flash_grads[n].to(dev, torch.float64)
                gx = t.grad.to(torch.float64)
                dot += float((gf * gx).sum())
                nf += float((gf * gf).sum())
                nx += float((gx * gx).sum())
            cos = dot / math.sqrt(nf * nx)
            # each attention projection of each layer on its own: the K5/K6
            # gradients reach the LM through these only
            attn_cos = {f"{n}[{i}]": _cosine(flash_grads[n][i].to(dev), t.grad[i])
                        for n, t in lm_leaves.items() if re.fullmatch(r"lm/layers/[qkvo]_proj/\w+", n)
                        for i in range(t.shape[0])}
        trainer.tx.zero_grad()
    del flash_grads
    diff = abs(losses["flash"] - losses["xla"])
    worst = min(attn_cos, key=attn_cos.get)
    log(f"[6] flash vs xla: |loss diff| {diff:.3e} (tol {LOSS_ATOL}), cosine of the LM gradients "
        f"{cos:.6f} (min {GRAD_COS_MIN}); worst of {len(attn_cos)} per-layer q/k/v/o_proj "
        f"gradients {worst} {attn_cos[worst]:.6f} (min {GRAD_COS_MIN})")
    if (not all(math.isfinite(x) for x in losses.values()) or diff > LOSS_ATOL
            or cos < GRAD_COS_MIN or attn_cos[worst] < GRAD_COS_MIN):
        raise AssertionError("flash and xla training passes disagree")

    snap = {n: t.detach().to("cpu", copy=True) for n, t in _named_leaves(params).items()}
    torch.cuda.reset_peak_memory_stats()
    step_losses, walls, counts = _micro_steps(trainer, batch, 4, STAGE2_LAUNCHES, "6")
    wall = walls[2] + walls[3]
    rows = tcfg.gradient_accumulation_steps * tcfg.model_max_length
    log(f"[6] micro-step losses {step_losses}")
    real = tcfg.gradient_accumulation_steps * n_real
    log(f"[6] second optimizer step: wall {wall:.3f} s, {real / wall:.1f} non-pad tokens/s "
        f"({real} tokens: 2 micro-steps x {n_real}), {rows / wall:.1f} LM rows/s "
        f"({rows} rows: 2 micro-steps x {tcfg.model_max_length})")
    log(f"[6] max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if trainer.tx.count != 2:
        raise AssertionError(f"{trainer.tx.count} optimizer updates, expected 2")
    _check_changes("6", params, snap, {"lm", "sva", "compressor", "image_newline"},
                   {"siglip", "dino"}, zero_grad)
    # a fifth micro-step (it accumulates, no update) under the profiler
    profile_stage("6", "micro-step 5 under torch.profiler", lambda: trainer.train_step(batch))
    del trainer, snap, view
    clear_grads(params)
    ms, f32_ms = head_loss_ms(cfg, params, tcfg.model_max_length - 1, tcfg.loss_chunk)
    log(f"[6] lm_loss's chunked head alone ({tcfg.model_max_length - 1} rows, chunks of "
        f"{tcfg.loss_chunk}, forward + recompute + backward): {ms:.3f} ms device through "
        f"layers.dot_f32 (bf16 GEMMs, f32 out, the cast hoisted), {f32_ms:.3f} ms through the "
        f"f32 product it replaced (per-chunk cast, f32 copies); {card()}")
    clear_grads(params)
    return params, counts


def clear_grads(params):
    for t in _leaves(params):
        t.grad = None


def head_loss_ms(cfg, params, n_rows: int, chunk: int):
    """Device ms of lm_loss's head alone (logits, log-softmax, the checkpoint
    recompute and the backward into the hidden states and the head weight)
    at n_rows rows: through the port's head (one bf16 cast of the weight,
    bf16 GEMMs with f32 output), and through the f32 product the port ran
    before (the weight cast in every chunk and recompute, f32 copies of
    both operands), on the same inputs."""
    from torch.utils.checkpoint import checkpoint

    from tdc_video_tpu_torch.models import lm as lm_mod

    lmp = params["lm"]
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    h = torch.randn((1, n_rows, cfg.lm.hidden_size), generator=g, device=DEVICE).to(cfg.dtype)
    h.requires_grad_()
    tgt = torch.randint(0, cfg.lm.vocab_size, (1, n_rows), generator=g, device=DEVICE)
    vf = torch.ones((1, n_rows), device=DEVICE)

    def f32_ll(hc, tc, vc, _head):
        w = lm_mod.head_weight(cfg.lm, lmp, hc.dtype)[0]
        logp = torch.log_softmax(hc.float() @ w.float(), dim=-1)
        return (torch.take_along_dim(logp, tc[..., None], dim=-1)[..., 0] * vc).sum()

    def port_ll(hc, tc, vc, head):
        return lm_mod._token_ll(cfg.lm, lmp, hc, tc, vc, head)

    def run(fn, hoist):
        head = lm_mod.head_weight(cfg.lm, lmp, cfg.dtype) if hoist else None
        total = 0.0
        for c0 in range(0, n_rows, chunk):
            sl = slice(c0, c0 + chunk)
            total = total + checkpoint(fn, h[:, sl], tgt[:, sl], vf[:, sl], head,
                                       use_reentrant=False)
        total.backward()

    return (time_ms(lambda: run(port_ll, True), reps=1, rounds=3, warmup=1),
            time_ms(lambda: run(f32_ll, False), reps=1, rounds=3, warmup=1))


def phase_tower_train(cfg, params):
    """The stage-2 preset with the towers trainable and the LM frozen: 2
    optimizer steps of one micro-step each; the tower backward runs K4 (the
    forward recomputed with lse), K5 and K6.  Frames cut 8 -> 4 -> 2 on
    running out of memory."""
    from tdc_video_tpu_torch.train.stages import stage2_video_sft
    from tdc_video_tpu_torch.train.trainer import Trainer

    tcfg = dataclasses.replace(stage2_video_sft(), unfreeze_mm_vision_tower=True,
                               freeze_backbone=True, gradient_accumulation_steps=1, max_steps=2,
                               report_to="none")
    snap = {n: t.detach().to("cpu", copy=True) for n, t in _named_leaves(params).items()}
    for n_frames in (TOWER_FRAMES, TOWER_FRAMES // 2, TOWER_FRAMES // 4):
        for t in _named_leaves(params).values():
            t.grad = None
        torch.cuda.reset_peak_memory_stats()
        trainer = oom = None
        try:
            trainer = Trainer(cfg, tcfg, params, total_steps=tcfg.max_steps, device=DEVICE)
            n_train = sum(t.numel() for t in trainer.tx.params)
            log(f"[7] {n_frames} frames; trainable {n_train / 1e9:.3f} B params (towers, SVA, "
                f"compressor, image_newline); LM frozen")
            batch = train_batch(cfg, n_frames)
            losses, walls, counts = _micro_steps(trainer, batch, 2, TOWER_LAUNCHES, "7")
            break
        except torch.cuda.OutOfMemoryError as e:
            oom = str(e).splitlines()[0]
        # out of the handler, the traceback no longer holds the step's tensors
        trainer = None
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[7] out of memory at {n_frames} frames ({oom}); cut to {n_frames // 2} frames")
        with torch.no_grad():
            for n, t in _named_leaves(params).items():
                t.copy_(snap[n])
    else:
        raise AssertionError("the tower-trainable step does not fit at 2 frames")
    log(f"[7] step walls {[round(w, 3) for w in walls]} s, max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, max_memory_reserved "
        f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} GiB")
    # a third step (one more update) under the profiler, at the frames that ran
    profile_stage("7", f"micro-step 3 under torch.profiler ({n_frames} frames)",
                  lambda: trainer.train_step(batch))
    del trainer
    zero_grad = set()  # after zero_grad every grad is 0: judge the towers by their change
    _check_changes("7", params, snap, {"siglip", "dino"}, {"lm"}, zero_grad)
    return n_frames, counts


# ---------------------------------------------------------------------------
# Phase 8
# ---------------------------------------------------------------------------

# the depths phase 8's checkpoint is cut to (widths stay the preset's)
CKPT_LAYERS = {"lm": 4, "siglip": 4, "dino": 4}
# the demo's clip: 16 s at 25 fps gives 16 frames at 1 fps
CLIP = {"w": 160, "h": 120, "fps": 25.0, "n_frames": 400}
MAIN_KERNELS = ("flash_kernel", "full_attention_nhd", "full_attention_nhd_seqq")


def _answer_launches(pred, frames, tag):
    """One answer with the launch counters set to 0 just before and read
    just after; fails unless K1-K3 ran.  Returns (the answer's ids, the
    counts)."""
    from tdc_video_tpu_torch.ops import flash_attention as fa

    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    pred.answer(frames, QUESTION, max_new_tokens=MAX_NEW_TOKENS)
    wall = time.perf_counter() - t0
    counts = dict(fa.launches)
    st = pred.stats
    log(f"[8] {tag}: ids {st.last_ids}; wall {wall:.3f} s: encode {st.encode_s:.3f} s, "
        f"compress+prefill {st.prefill_s:.3f} s, decode {st.decode_s:.3f} s; launches {json.dumps(counts)}")
    missing = [k for k in MAIN_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{tag}: kernels {missing} were not launched")
    return list(st.last_ids), counts


def _check_pil_copy(frames, sizes):
    """Where PIL is installed, the port's numpy copy of its bicubic resize
    against PIL itself, bit for bit, on every frame padded to square, at
    each tower size; the seconds of each beside the other."""
    import importlib.util

    from tdc_video_tpu_torch.data.images import expand2square, pil_bicubic_resize

    if importlib.util.find_spec("PIL") is None:
        log("[8] PIL is not installed: the bicubic copy is not held to PIL here")
        return
    import PIL
    from PIL import Image

    squares = [expand2square(f, (127, 127, 127)) for f in frames]
    for size in sizes:
        t0 = time.perf_counter()
        ref = [np.asarray(Image.fromarray(sq).resize((size, size), Image.BICUBIC)) for sq in squares]
        pil_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = [pil_bicubic_resize(sq, size, size) for sq in squares]
        copy_s = time.perf_counter() - t0
        n_diff = sum(int((a != b).sum()) for a, b in zip(out, ref))
        log(f"[8] PIL {PIL.__version__} bicubic {len(squares)} frames {squares[0].shape[0]} -> "
            f"{size}: the port's copy {copy_s:.3f} s, PIL {pil_s:.3f} s on the host; it differs in "
            f"{n_diff} of {len(ref) * ref[0].size} values")
        if n_diff:
            raise AssertionError("the port's bicubic resize differs from PIL's")


def phase_checkpoint(has_ffmpeg: bool, ffmpeg_msg: str):
    """Checkpoint round trip, the host path and the demo (module docstring,
    phase 8).  Returns the launch counts of the loaded checkpoint's answer
    and of the demo's (None where the machine has no FFmpeg libraries)."""
    from tdc_video_tpu_torch.config import tdc_llama32_3b

    full = tdc_llama32_3b()
    cfg = dataclasses.replace(
        full, lm=dataclasses.replace(full.lm, num_layers=CKPT_LAYERS["lm"]),
        siglip=dataclasses.replace(full.siglip, num_layers=CKPT_LAYERS["siglip"]),
        dino=dataclasses.replace(full.dino, num_layers=CKPT_LAYERS["dino"]))
    log(f"[8] checkpoint: TDC-Llama3.2-3B at full width (hidden {cfg.lm.hidden_size}, heads "
        f"{cfg.lm.num_heads}/{cfg.lm.num_kv_heads}, vocab {cfg.lm.vocab_size}, SigLIP "
        f"{cfg.siglip.hidden_size}, DINOv2 {cfg.dino.hidden_size}); depth cut: LM "
        f"{full.lm.num_layers} -> {cfg.lm.num_layers}, SigLIP {full.siglip.num_layers} -> "
        f"{cfg.siglip.num_layers}, DINOv2 {full.dino.num_layers} -> {cfg.dino.num_layers} layers")
    with tempfile.TemporaryDirectory(prefix="tdc_ckpt_") as tmp:
        path = os.path.join(tmp, "TDC-Llama3.2-3B-cut")
        counts = _round_trip_and_host_path(cfg, path)
        if not has_ffmpeg:
            log(f"[8] clip leg (cli/demo and cli/serve) skipped: pkg-config finds no FFmpeg "
                f"libraries on this machine: "
                f"{' | '.join(ffmpeg_msg.splitlines())}")
            return counts, None
        return counts, _demo_clip(path, os.path.join(tmp, "clip.mp4"))


def _round_trip_and_host_path(cfg, path):
    """Legs 1-4: write the checkpoint, load it as the demo does, hold it and
    its answer to the in-memory weights, then answer on the host path."""
    from tdc_video_tpu_torch.builder import load_pretrained_model
    from tdc_video_tpu_torch.convert.to_hf import save_checkpoint_dir
    from tdc_video_tpu_torch.data.images import process_frames
    from tdc_video_tpu_torch.eval.runner import TDCPredictor
    from tdc_video_tpu_torch.model import init_tdc
    from tdc_video_tpu_torch.serving.generate import prefill_encoded

    dev = torch.device(DEVICE)
    params = init_tdc(cfg, torch.Generator(device=dev).manual_seed(SEED), dev, torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_checkpoint_dir(params, cfg, path)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(path, "model.safetensors"))
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[8] save_checkpoint_dir: {n_params} params, {nbytes} bytes ({nbytes / 1e9:.3f} GB, f32) "
        f"in {save_s:.3f} s")
    # the in-memory reference: the f32 weights just written
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # as cli/demo.run loads: bf16 compute, the weights in cfg.param_dtype (f32)
    _, model, _, _ = load_pretrained_model(path, load_tokenizer=False, dtype=torch.bfloat16,
                                           device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"[8] load_pretrained_model (dtype bf16, weights {model.cfg.param_dtype}): {load_s:.3f} s, "
        f"{nbytes / load_s / 1e9:.3f} GB/s of checkpoint, peak device memory {peak / 2**30:.3f} GiB "
        f"(of which {held / 2**30:.3f} GiB the in-memory reference held before the load)")
    if model.cfg != cfg:
        raise AssertionError(f"config read back differs: {model.cfg} vs {cfg}")
    n_leaves, diff = _compare_trees(model.params, params)
    log(f"[8] loaded weights vs in-memory: {n_leaves} leaves, {len(diff)} differ")
    if diff:
        raise AssertionError(f"loaded weights differ from the in-memory ones: {diff[:5]}")

    frames = synth_frames(SEED)
    mem = TDCPredictor(cfg, params, ByteTokenizer(), device_preprocess=True, device=dev)
    loaded = TDCPredictor(model.cfg, model.params, ByteTokenizer(), device_preprocess=True,
                          device=dev)
    for pred in (mem, loaded):  # first answers pay one-time costs
        pred.answer(frames, QUESTION, max_new_tokens=MAX_NEW_TOKENS)
    ids_mem, _ = _answer_launches(mem, frames, "in-memory, device preprocessing")
    ids_dev, counts = _answer_launches(loaded, frames, "loaded checkpoint, device preprocessing")
    if ids_dev != ids_mem:
        raise AssertionError(f"the loaded model answers {ids_dev}, the in-memory one {ids_mem}")
    # a random model at this depth may repeat one token: the prefill logits
    # are held too, bit for bit (same weights, same deterministic kernels)
    req = loaded.prepare(frames, QUESTION, max_new_tokens=MAX_NEW_TOKENS)
    logits = [prefill_encoded(p.cfg, p.params, **req["gen"], attn_impl=p.attn_impl)[0]
              for p in (mem, loaded)]
    if not torch.equal(*logits):
        raise AssertionError("prefill logits of the loaded and in-memory models differ")
    log(f"[8] round trip: the loaded model's answer is token-identical to the in-memory one "
        f"and its prefill logits {tuple(logits[0].shape)} bitwise equal")
    dev_encode = loaded.stats.encode_s

    host = TDCPredictor(model.cfg, model.params, ByteTokenizer(), device=dev)  # the default path
    if host.device_preprocess:
        raise AssertionError("the predictor's default is not the host path")
    t0 = time.perf_counter()
    process_frames(list(frames), model.cfg)
    prep_s = time.perf_counter() - t0
    ids_host, _ = _answer_launches(host, frames, "loaded checkpoint, host preprocessing")
    log(f"[8] host path: process_frames of {len(frames)} {FRAME_H}x{FRAME_W} frames {prep_s:.3f} s "
        f"on the host; encode {host.stats.encode_s:.3f} s (host path) vs {dev_encode:.3f} s "
        f"(device path); answers {'identical' if ids_host == ids_dev else 'differ'} "
        f"({ids_host} vs {ids_dev})")
    _check_pil_copy(frames, (cfg.siglip.image_size, cfg.dino.image_size))
    return counts


def _demo_clip(ckpt, clip):
    """Leg 5: cli/demo.run on the checkpoint and a 16 s clip, on the card,
    with the launch counters set to 0 just before and read just after."""
    from tdc_video_tpu_torch.cli import demo
    from tdc_video_tpu_torch.media.io import encode_test_video
    from tdc_video_tpu_torch.ops import flash_attention as fa

    gc.collect()
    torch.cuda.empty_cache()
    encode_test_video(clip, **CLIP)
    args = demo.parse_args(["--model_path", ckpt, "--video", clip, "--question", QUESTION,
                            "--bert_tokenizer", "", "--max_new_tokens", str(MAX_NEW_TOKENS),
                            "--device", DEVICE])
    torch.cuda.synchronize()
    fa.reset_launches()
    out = demo.run(args, tokenizer=ByteTokenizer())
    torch.cuda.synchronize()
    counts = dict(fa.launches)
    log(f"[8] demo: {out['n_frames']} frames decoded in {out['decode_s']:.3f} s, load "
        f"{out['load_s']:.3f} s, answer {out['answer_s']:.3f} s, ids {out['ids']}, launches "
        f"{json.dumps(counts)}")
    missing = [k for k in MAIN_KERNELS if counts[k] <= 0]
    if out["n_frames"] != 16 or missing:
        raise AssertionError(f"demo: {out['n_frames']} frames, kernels not launched: {missing}")
    _serve_clip(ckpt, clip)
    return counts


def _serve_clip(ckpt, clip):
    """cli/serve on the same checkpoint and clip: 2 questions in 2 slots,
    K1-K3 launched."""
    from tdc_video_tpu_torch.cli import serve
    from tdc_video_tpu_torch.ops import flash_attention as fa

    args = serve.parse_args(["--model_path", ckpt, "--video", clip, "--question", QUESTION,
                             "--question", SERVE_QUESTIONS[1], "--slots", "2", "--bert_tokenizer",
                             "", "--max_new_tokens", str(MAX_NEW_TOKENS), "--device", DEVICE])
    torch.cuda.synchronize()
    fa.reset_launches()
    out = serve.run(args, tokenizer=ByteTokenizer())
    torch.cuda.synchronize()
    counts = dict(fa.launches)
    log(f"[8] serve: {out['n_frames']} frames, {len(out['answers'])} answers in "
        f"{out['seconds']:.3f} s, ids {out['ids']}, launches {json.dumps(counts)}")
    missing = [k for k in MAIN_KERNELS if counts[k] <= 0]
    if len(out["answers"]) != 2 or missing:
        raise AssertionError(f"serve: {len(out['answers'])} answers, kernels not launched: "
                             f"{missing}")


# ---------------------------------------------------------------------------
# Phase 9
# ---------------------------------------------------------------------------

# the request the demo sends for a 96 s clip: 96 frames decoded at 1 fps and
# the clip's 16 kHz soundtrack (ten 10-s windows, the last one 6 s of audio
# and 4 s of padding), silent from 90 s on.  96 frames fall in the 128-frame
# bucket, whose visual cap (5632) holds even the most chunks 25 segments
# can make of them (33: 33 x 129 + 63 x 17 = 5328 tokens), so no chunk is cut
AV_SECONDS, AV_SILENT_FROM = 96, 90
AV_FRAME_SECONDS = np.arange(AV_SECONDS, dtype=np.float64)
AV_TOKENS = 50  # audio tokens fused into each chunk's static frame
# encode_audio on the card against the host CPU, both f32 with TF32 off:
# the CPU test's bound against JAX (tests/test_torch_audio.py
# ENCODE_AUDIO_TOL), absolute and relative
ENCODE_AUDIO_TOL = 2e-4


class QwenByteTokenizer(ByteTokenizer):
    """ByteTokenizer with Qwen2's ChatML specials."""

    SPECIALS = {"<|im_start|>": 151644, "<|im_end|>": 151645, "<|endoftext|>": 151643}


def synth_wav(seed: int, seconds: int = AV_SECONDS) -> np.ndarray:
    """`seconds` of 16 kHz mono: three tones whose loudness changes every
    few seconds, with noise, silent from AV_SILENT_FROM seconds on."""
    rng = np.random.default_rng(seed)
    n = seconds * 16000
    x = np.arange(n) / 16000
    env = np.repeat(rng.uniform(0.2, 1.0, (seconds // 4 + 1, 3)), 4 * 16000, axis=0)[:n]
    wav = sum(0.2 * env[:, i] * np.sin(2 * np.pi * f0 * x)
              for i, f0 in enumerate((220.0, 440.0, 1250.0)))
    wav = (wav + 0.03 * rng.normal(size=n)).astype(np.float32)
    wav[AV_SILENT_FROM * 16000:] = 0.0
    return wav


def _tree_to(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_to(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, fn) for v in tree)
    return None if tree is None else fn(tree)


def phase_audio_visual():
    """Phase 9: audio-visual QA with TDC-Qwen2-7B at full width and depth
    (module docstring).  Returns (the K1 row at this prefill's shape, the
    launch counts of the warm answer, {"cfg", "params"}: the bf16 model,
    which phase 11 trains on)."""
    from tdc_video_tpu_torch.compress.tdc import assign_chunks
    from tdc_video_tpu_torch.config import tdc_qwen2_7b
    from tdc_video_tpu_torch.eval.runner import TDCPredictor, audio_request, prefill_shape
    from tdc_video_tpu_torch.model import encode_audio, init_tdc, prepare_visual
    from tdc_video_tpu_torch.models import lm as lm_mod
    from tdc_video_tpu_torch.models.beats import beats_forward
    from tdc_video_tpu_torch.models.layers import linear
    from tdc_video_tpu_torch.ops import flash_attention as fa
    from tdc_video_tpu_torch.ops.audio import kaldi_fbank, pool_seconds_to_frames, window_to_seconds
    from tdc_video_tpu_torch.ops.segment import segment_boundaries
    from tdc_video_tpu_torch.serving.generate import prefill_encoded

    cfg = tdc_qwen2_7b(audio=True)
    dev = torch.device(DEVICE)
    tok = QwenByteTokenizer()
    log(f"[9] TDC-Qwen2-7B audio-visual at full width and depth: LM {cfg.lm.num_layers} layers "
        f"hidden {cfg.lm.hidden_size} heads {cfg.lm.num_heads}/{cfg.lm.num_kv_heads} vocab "
        f"{cfg.lm.vocab_size} ({'tied' if cfg.lm.tie_word_embeddings else 'untied'} head), "
        f"SigLIP {cfg.siglip.num_layers}, DINOv2 {cfg.dino.num_layers}, BEATs "
        f"{cfg.beats.num_layers} layers at {cfg.beats.encoder_embed_dim}")
    t0 = time.perf_counter()
    params = init_tdc(cfg, torch.Generator(device=dev).manual_seed(SEED), dev, torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_audio = sum(t.numel() for k in ("beats", "audio_proj") for t in _leaves(params[k]))
    log(f"[9] init_tdc {n_params / 1e9:.3f} B params bf16 ({n_audio / 1e6:.1f} M of them BEATs + "
        f"audio_proj) in {time.perf_counter() - t0:.1f} s")
    frames, wav = synth_frames(SEED, len(AV_FRAME_SECONDS)), synth_wav(SEED)
    av = {"wav": wav, "frame_seconds": AV_FRAME_SECONDS}
    log(f"[9] request: {len(frames)} frames {FRAME_H}x{FRAME_W} at 1 fps (seconds 0 to "
        f"{int(AV_FRAME_SECONDS[-1])}), wav {len(wav) / 16000:g} s (silent from "
        f"{AV_SILENT_FROM} s), max_new_tokens {MAX_NEW_TOKENS}")
    pred = TDCPredictor(cfg, params, tok, bert_tokenizer=None, device_preprocess=True, device=dev)

    # the K1 row at this prefill's shape (Qwen2-7B's GQA: 28 query heads
    # over 4 KV heads)
    T, S = prefill_shape(cfg, tok, QUESTION, len(frames), MAX_NEW_TOKENS)
    log(f"[9] K1 at the audio-visual prefill shape T={T} S={S}")
    row = _fwd_row(fa, _rnd_fn(SEED + 9), "flash_kernel", "tdc_video_tpu/ops/flash_attention.py:38",
                   (1, T, S, cfg.lm.num_heads, cfg.lm.num_kv_heads, cfg.lm.head_dim), True)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    text = pred.answer(frames, QUESTION, max_new_tokens=MAX_NEW_TOKENS, **av)
    cold = time.perf_counter() - t0
    ids = list(pred.stats.last_ids)
    log(f"[9] first answer: wall {cold:.3f} s, ids {ids} text {text!r}")
    torch.cuda.synchronize()
    fa.reset_launches()
    t0 = time.perf_counter()
    pred.answer(frames, QUESTION, max_new_tokens=MAX_NEW_TOKENS, **av)
    wall = time.perf_counter() - t0
    counts = dict(fa.launches)
    st = pred.stats
    peak = torch.cuda.max_memory_allocated()
    log(f"[9] warm answer: wall {wall:.3f} s: encode {st.encode_s:.3f} s, audio {st.audio_s:.3f} s, "
        f"compress+prefill {st.prefill_s:.3f} s, decode {st.decode_s:.3f} s ({st.decode_steps} "
        f"steps, {st.decode_s / max(st.decode_steps, 1):.4f} s per token); peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {json.dumps(counts)}")
    if list(st.last_ids) != ids:
        raise AssertionError(f"[9] the warm answer differs: {st.last_ids} vs {ids}")
    # (a) K1, K2 and K3 ran on this path
    missing = [k for k in MAIN_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"[9] kernels {missing} were not launched")
    row["launches"] = counts["flash_kernel"]

    # (c) flash vs xla prefill of the audio-visual request
    phase_flash_vs_xla(cfg, params, pred, frames, tag="9", **av)

    # (d) the audio reaches the sequence: 50 more tokens in every chunk's
    # static block, at the request's own visual cap
    gen_av = pred.prepare(frames, QUESTION, max_new_tokens=MAX_NEW_TOKENS, **av)["gen"]
    gen_v = pred.prepare(frames, QUESTION, max_new_tokens=MAX_NEW_TOKENS)["gen"]
    if gen_v["max_visual_len"] != gen_av["max_visual_len"]:
        raise AssertionError("[9] the wav changes the request's visual cap")
    if gen_v["audio_tokens"] is not None:
        raise AssertionError("[9] a request without a wav carries audio tokens")

    def n_visual(gen):
        return int(prepare_visual(cfg, params, gen["frame_feats"][0], gen["dino_feats"][0],
                                  gen["frame_mask"][0], gen["qformer_text_ids"][0],
                                  gen["qformer_text_mask"][0],
                                  None if gen["audio_tokens"] is None else gen["audio_tokens"][0],
                                  max_visual_len=gen["max_visual_len"],
                                  token_valid=gen["token_valid"][0],
                                  query_pool=gen["query_pool"][0])[1])

    boundary = segment_boundaries(gen_av["dino_feats"][0], gen_av["frame_mask"][0],
                                  cfg.compression.max_num_segments)
    n_chunks = int(assign_chunks(boundary, gen_av["frame_mask"][0], cfg.compression.chunk_size)[2])
    nv_av, nv_v = n_visual(gen_av), n_visual(gen_v)
    log(f"[9] at the request's visual cap {gen_av['max_visual_len']}: n_visual with the wav "
        f"{nv_av}, without {nv_v}; {n_chunks} chunks in {int(boundary.sum())} segments")
    if nv_av - nv_v != AV_TOKENS * n_chunks:
        raise AssertionError(f"[9] audio adds {nv_av - nv_v} tokens, not {AV_TOKENS} x {n_chunks}")
    # and they move the LM: the prefill logits with and without the wav
    lg = [prefill_encoded(cfg, params, **g, attn_impl="flash")[0].float() for g in (gen_av, gen_v)]
    moved = float((lg[0] - lg[1]).abs().max())
    log(f"[9] prefill T={gen_av['max_len']}: logits with and without the wav differ by up to "
        f"{moved:.4e}")
    if not moved > 0 or not all(bool(torch.isfinite(x).all()) for x in lg):
        raise AssertionError("[9] the audio tokens do not reach the LM")

    # (e) encode_audio on the card against the host CPU, f32, TF32 off; (f)
    # two calls on the card give the same bits, in f32 and in bf16
    nT = gen_av["frame_mask"].shape[1]
    host = audio_request(wav, nT, AV_FRAME_SECONDS)
    args = [torch.from_numpy(x) for x in host]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = {k: _tree_to(params[k], lambda x: x.float()) for k in ("beats", "audio_proj")}
    p_cpu = _tree_to(p32, lambda x: x.cpu())
    dargs = [a.to(dev) for a in args]

    def enc(c, p, a):
        return encode_audio(c, p, *a[:5], nT, sec_valid=a[5])

    t0 = time.perf_counter()
    ref = enc(cfg32, p_cpu, args)
    cpu_s = time.perf_counter() - t0
    out = [enc(cfg32, p32, dargs) for _ in range(2)]
    outb = [enc(cfg, params, dargs) for _ in range(2)]
    torch.cuda.synchronize()
    diff = (out[0].cpu() - ref).abs()
    ok = bool(torch.allclose(out[0].cpu(), ref, atol=ENCODE_AUDIO_TOL, rtol=ENCODE_AUDIO_TOL))
    log(f"[9] encode_audio f32, card vs host CPU ({cpu_s:.2f} s there): {tuple(ref.shape)}, max_abs "
        f"{float(diff.max()):.3e} on values up to {float(ref.abs().max()):.3f} (tol "
        f"{ENCODE_AUDIO_TOL:g} abs + rel) {'ok' if ok else 'FAIL'}")
    same = [torch.equal(*out), torch.equal(*outb)]
    log(f"[9] encode_audio twice on the card: bitwise equal in f32 {same[0]}, in bf16 {same[1]}")
    if not ok or not all(torch.isfinite(o).all() for o in out + outb):
        raise AssertionError("[9] encode_audio on the card disagrees with the host CPU")
    if not all(same):
        raise AssertionError("[9] two encode_audio calls on the card differ")

    # encode_audio's stages at the served dtype, each timed alone
    wins, wmask = dargs[0], dargs[1]
    fb = kaldi_fbank(wins)
    fb_mask = wmask[:, ::160][:, : fb.shape[1]]
    tokens, _ = beats_forward(cfg.beats, params["beats"], fb, fb_mask, dtype=cfg.dtype)

    def pool():
        per_sec = window_to_seconds(tokens)
        per_sec = per_sec.reshape((-1,) + per_sec.shape[2:])
        fr = pool_seconds_to_frames(per_sec, *dargs[2:5], nT, dargs[5])
        return linear(params["audio_proj"], fr.to(cfg.dtype))

    stages = {"fbank": lambda: kaldi_fbank(wins),
              "beats": lambda: beats_forward(cfg.beats, params["beats"], fb, fb_mask,
                                             dtype=cfg.dtype),
              "pool+audio_proj": pool, "encode_audio": lambda: enc(cfg, params, dargs)}
    ms = {k: time_ms(fn, reps=5, rounds=3) for k, fn in stages.items()}
    log(f"[9] encode_audio bf16 ({wins.shape[0]} windows, {tokens.shape[1]} BEATs tokens each): "
        + ", ".join(f"{k} {v / 1e3:.5f} s" for k, v in ms.items()))
    profile_stage("9", "encode_audio (bf16)", lambda: enc(cfg, params, dargs))

    # decode: the untied head of a step, through layers.dot_f32 (a bf16 GEMV
    # with f32 output) and through the f32 product it replaced (an f32 copy
    # of the head made and read every step)
    hidden = torch.randn((1, 1, cfg.lm.hidden_size), device=dev).to(cfg.dtype)
    head_ms = time_ms(lambda: lm_mod.lm_head(cfg.lm, params["lm"], hidden), reps=5, rounds=3)
    w_head = params["lm"]["lm_head"]["w"]
    f32_ms = time_ms(lambda: hidden.float() @ w_head.to(hidden.dtype).float(), reps=5, rounds=3)
    head_bytes = cfg.lm.hidden_size * cfg.lm.vocab_size
    log(f"[9] decode {st.decode_s / max(st.decode_steps, 1):.4f} s per token; lm_head alone "
        f"{head_ms:.3f} ms device a step ({head_bytes * 2 / 1e9:.2f} GB bf16 head read once, "
        f"bound {head_bytes * 2 / PEAK_BYTES * 1e3:.3f} ms), {f32_ms:.3f} ms through the f32 "
        f"product it replaced (a {head_bytes * 4 / 1e9:.2f} GB f32 copy made and read); {card()}")
    del pred, p32, p_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return row, counts, {"cfg": cfg, "params": params}


# ---------------------------------------------------------------------------
# Phase 11
# ---------------------------------------------------------------------------

# stage 3 (audio-visual LoRA): one sample of 64 frames with its 64 s
# soundtrack (seven 10-s windows) at the preset's 8192 rows; per micro-step
# the launches of phase 6 (Qwen2-7B has 28 layers, as Llama-3.2-3B)
S3_FRAMES = 64
S3_SECONDS = 64
S3_LAUNCHES = dict(STAGE2_LAUNCHES)
# QLoRA's export against dequantize + merge recomputed on the host in f32:
# the dequantized weight is one exactly rounded product on both; the delta
# A @ B sums 128 products in another order, and the sum with the weight
# rounds once: within 1e-6 relative (a few ulps), far below a missing delta
S3_EXPORT_RTOL, S3_EXPORT_ATOL = 1e-6, 1e-8
# (e): the checkpoint and CLI model, Qwen2-7B(audio) at full width with its
# depths cut as phase 8 cuts its model; its sample and the CLI's frames
S3_CUT_FRAMES = 16
S3_CUT_T = 4096
S3_CLI_FRAMES = (16, 120, 160)


def audio_arrays(wav: np.ndarray, n_frames: int, n_windows: int):
    """The audio keys of train/dataset.Collator for one sample whose frames
    are one a second (its _audio_arrays, from a wav in memory): the 10-s
    windows and masks, and the second groups of the frames."""
    from tdc_video_tpu_torch.media.io import window_audio
    from tdc_video_tpu_torch.ops.audio import second_groups

    S = n_windows * 10
    win = np.zeros((1, n_windows, 160000), np.float32)
    wmask = np.zeros((1, n_windows, 160000), bool)
    ws, ms = window_audio(wav)
    n = min(len(ws), n_windows)
    win[0, :n], wmask[0, :n] = ws[:n], ms[:n]
    kb = np.zeros(S, np.int64)
    kb[:min(S, n_frames)] = 1
    f, p, g = second_groups(kb)
    g_size = np.ones((1, n_frames), np.int32)
    g_size[0, :min(len(g), n_frames)] = g[:n_frames]
    return {"audio_windows": win, "audio_wmask": wmask,
            "audio_frame_of_sec": np.clip(f, 0, n_frames - 1)[None].astype(np.int32),
            "audio_group_pos": p[None].astype(np.int32), "audio_group_size": g_size,
            "audio_sec_valid": (np.arange(S) < max(1, len(wav) // 16000))[None]}


def stage3_batch(cfg, n_frames: int, seconds: int):
    """One stage-3 sample: train_batch's conversation and frames (ChatML) and
    a `seconds` soundtrack, as the trainer's batch dict."""
    batch = train_batch(cfg, n_frames, QwenByteTokenizer())
    batch.update(audio_arrays(synth_wav(SEED + 11, seconds), n_frames, -(-seconds // 10)))
    return batch


def stage3_params(params):
    """The trainer's tree over a bf16 model: the LM, towers and BEATs are the
    bf16 tensors themselves (the frozen base), the modules stage 3 trains
    (SVA, compressor, image_newline, audio_proj) f32 copies."""
    keep = ("lm", "siglip", "dino", "beats")
    return {k: v if k in keep else _tree_to(v, lambda x: x.detach().float().clone())
            for k, v in params.items()}


def _to_dev(cfg, batch):
    b = {k: torch.as_tensor(v).to(DEVICE) for k, v in batch.items()}
    for k in ("siglip_px", "dino_px"):
        b[k] = b[k].to(cfg.dtype)
    return b


def _non_pad_rows(cfg, tcfg, params, b) -> int:
    """The spliced sequence's non-pad rows (text, visual and audio tokens)."""
    from tdc_video_tpu_torch.model import prepare_multimodal_inputs

    audio = {k: b[k] for k in b if k.startswith("audio_")}
    with torch.no_grad():
        mm = prepare_multimodal_inputs(
            cfg, params, b["input_ids"], b["image_pos"], b["siglip_px"], b["dino_px"],
            b["frame_mask"], b["qformer_text_ids"], b["qformer_text_mask"], labels=b["labels"],
            text_len=b["text_len"], has_image=b["has_image"], token_valid=b["token_valid"],
            query_pool=b["query_pool"], max_len=tcfg.model_max_length,
            max_visual_len=tcfg.max_visual_len, attn_impl="flash", **audio)
    return int(mm["attn_mask"].sum())


def _lora_steps(trainer, batch, tag, n_real):
    """4 micro-steps (2 optimizer steps) through Trainer.train_step, the
    launch counters read per micro-step; the second optimizer step's
    non-pad tokens/s; returns (losses, counts, peak GiB)."""
    tcfg = trainer.tcfg
    torch.cuda.reset_peak_memory_stats()
    losses, walls, counts = _micro_steps(trainer, batch, 4, S3_LAUNCHES, tag)
    wall = walls[2] + walls[3]
    real = tcfg.gradient_accumulation_steps * n_real
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] micro-step losses {losses}; second optimizer step: wall {wall:.3f} s, "
        f"{real / wall:.1f} non-pad tokens/s ({real} tokens: 2 micro-steps x {n_real}), "
        f"{2 * tcfg.model_max_length / wall:.1f} LM rows/s; max_memory_allocated {peak:.2f} GiB; "
        f"{card()}")
    if trainer.tx.count != 2:
        raise AssertionError(f"[{tag}] {trainer.tx.count} optimizer updates, expected 2")
    return losses, counts, peak


def _stage3_flash_vs_xla(cfg, trainer, b):
    """One loss-and-gradient pass with attn_impl "flash" and one with "xla"
    on the LoRA view of `trainer` (after its updates, so that B is not 0
    and A has a gradient): the losses within LOSS_ATOL, the cosine of all
    A/B gradients and of each layer's q/k/v/o adapters alone (A and B
    together) at least GRAD_COS_MIN."""
    from tdc_video_tpu_torch.model import tdc_loss
    from tdc_video_tpu_torch.train.step import lora_view, split_lora, train_view

    tcfg = trainer.tcfg
    extras, split = train_view(trainer.params), split_lora(trainer.lora)
    leaves = {f"{k}/{n}": t for k, ab in trainer.lora.items() for n, t in ab.items()}
    losses, grads = {}, {}
    for impl in ("flash", "xla"):
        trainer.tx.zero_grad()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # B's scale is a product made per pass (lora_view)
        view = dict(extras, lm=lora_view(trainer.params["lm"], split, tcfg.lora_alpha, tcfg.lora_r))
        loss = tdc_loss(cfg, view, b, max_len=tcfg.model_max_length,
                        max_visual_len=tcfg.max_visual_len, attn_impl=impl, remat=True,
                        loss_chunk=tcfg.loss_chunk)
        loss.backward()
        losses[impl] = float(loss.detach())
        grads[impl] = {n: t.grad.to("cpu", torch.float64, copy=True) for n, t in leaves.items()}
        log(f"[11] (b) {impl}: loss {losses[impl]:.6f}, loss+grads {time.perf_counter() - t0:.3f} s, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    trainer.tx.zero_grad()
    gf, gx = grads["flash"], grads["xla"]
    cos = _cosine(torch.cat([g.flatten() for g in gf.values()]),
                  torch.cat([g.flatten() for g in gx.values()]))
    per_layer = {}
    for p in ("q_proj", "k_proj", "v_proj", "o_proj"):
        a, bb = f"layers/{p}/w/a", f"layers/{p}/w/b"
        for i in range(gf[a].shape[0]):
            per_layer[f"{p}[{i}]"] = _cosine(torch.cat([gf[a][i].flatten(), gf[bb][i].flatten()]),
                                             torch.cat([gx[a][i].flatten(), gx[bb][i].flatten()]))
    worst = min(per_layer, key=per_layer.get)
    diff = abs(losses["flash"] - losses["xla"])
    log(f"[11] (b) flash vs xla: |loss diff| {diff:.3e} (tol {LOSS_ATOL}), cosine of all A/B "
        f"gradients {cos:.6f} (min {GRAD_COS_MIN}); worst of {len(per_layer)} per-layer q/k/v/o "
        f"adapters {worst} {per_layer[worst]:.6f} (min {GRAD_COS_MIN})")
    if (not all(math.isfinite(x) for x in losses.values()) or diff > LOSS_ATOL
            or cos < GRAD_COS_MIN or per_layer[worst] < GRAD_COS_MIN):
        raise AssertionError("[11] flash and xla LoRA passes disagree")


def stage3_kernel_rows(cfg):
    """K1, K5 and K6 at the stage-3 LM shape ([1, 8192, 28/4, 128], causal),
    each held to its plain version row by row at phase 2's bound and timed
    beside SDPA or its backward; returns their entries of the kernels line."""
    from tdc_video_tpu_torch.ops import flash_attention as fa

    rnd = _rnd_fn(SEED + 11)
    H, Hkv, D = cfg.lm.num_heads, cfg.lm.num_kv_heads, cfg.lm.head_dim
    label = f"stage-3 LM T={TRAIN_T} causal GQA {H}/{Hkv}"
    rows = [_fwd_row(fa, rnd, "flash_kernel", "tdc_video_tpu/ops/flash_attention.py:38",
                     (1, TRAIN_T, TRAIN_T, H, Hkv, D), True)]
    gc.collect()
    torch.cuda.empty_cache()
    rows[0]["shape"] = f"{label}: {rows[0]['shape']}"
    rows += _bwd_rows(rnd, label, (1, TRAIN_T, H, Hkv, D), True, False, torch.bfloat16, True)
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _check_export_on_host(trainer, merged):
    """QLoRA's export_merged against dequantize + merge recomputed on the
    host in f32, leaf by leaf: every leaf of the export, the int8 linears
    stacked over layers at their first, middle and last layer.  Returns
    (leaves and slices checked, those bitwise equal)."""
    from tdc_video_tpu_torch.models.quant import dequantize_linear

    tcfg = trainer.tcfg
    scale = tcfg.lora_alpha / tcfg.lora_r
    n = same = 0

    def held(name, out, ref):
        nonlocal n, same
        out = out.to("cpu")
        if out.dtype != ref.dtype or not torch.allclose(out, ref, rtol=S3_EXPORT_RTOL,
                                                        atol=S3_EXPORT_ATOL):
            raise AssertionError(f"[11] (d) export_merged {name}: max_abs "
                                 f"{float((out.float() - ref.float()).abs().max()):.3e}")
        n += 1
        same += bool(torch.equal(out, ref))

    def walk(q, m, path):
        if isinstance(q, dict) and "w_q" in q:
            ab = trainer.lora.get("/".join(path[1:] + ("w",))) if path[0] == "lm" else None
            stacked = q["w_q"].dim() == 3
            L = q["w_q"].shape[0]
            for i in (sorted({0, L // 2, L - 1}) if stacked else [None]):
                sl = (lambda x: x[i]) if stacked else (lambda x: x)
                ref = dequantize_linear({"w_q": sl(q["w_q"]).cpu(), "w_scale": sl(q["w_scale"]).cpu()},
                                        dtype=trainer.cfg.param_dtype)["w"]
                if ab is not None:
                    a, b = (sl(ab[k]).detach().cpu().float() for k in ("a", "b"))
                    ref = ref + ((a @ b) * scale).to(ref.dtype)
                held("/".join(path) + ("" if i is None else f"[{i}]"), sl(m["w"]), ref)
            for k in q:
                if k not in ("w_q", "w_scale"):
                    walk(q[k], m[k], path + (k,))
        elif isinstance(q, dict):
            for k in q:
                walk(q[k], m[k], path + (k,))
        elif isinstance(q, (list, tuple)):
            for i, (x, y) in enumerate(zip(q, m)):
                walk(x, y, path + (str(i),))
        elif q is not None:
            held("/".join(path), m, q.detach().cpu())

    for k in trainer.params:
        walk(trainer.params[k], merged[k], (k,))
    return n, same


def phase_stage3(av, has_ffmpeg: bool):
    """Phase 11: stage 3 on phase 9's TDC-Qwen2-7B(audio) (module docstring).
    Takes phase 9's model out of `av`.  Returns ({"lora", "qlora"}: launch
    counts of one micro-step, the K1/K5/K6 entries at the stage-3 shape)."""
    from tdc_video_tpu_torch.train.stages import stage3_audio_lora
    from tdc_video_tpu_torch.train.trainer import Trainer

    cfg, params = av["cfg"], av.pop("params")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tdc_stage3_") as tmp:
        tcfg = dataclasses.replace(stage3_audio_lora(os.path.join(tmp, "a")), max_steps=4,
                                   report_to="none")
        assert (tcfg.lora_r, tcfg.lora_alpha, tcfg.gradient_accumulation_steps, tcfg.loss_chunk,
                tcfg.model_max_length) == (128, 256, 2, 512, TRAIN_T)
        batch = stage3_batch(cfg, S3_FRAMES, S3_SECONDS)
        b = _to_dev(cfg, batch)
        n_text = int(batch["text_len"][0])
        log(f"[11] stage 3 (stage3_audio_lora: r {tcfg.lora_r}, alpha {tcfg.lora_alpha}, "
            f"accumulation {tcfg.gradient_accumulation_steps}, loss_chunk {tcfg.loss_chunk}) on "
            f"phase 9's TDC-Qwen2-7B(audio), frozen base bf16 (the preset's is f32), trainable "
            f"extras and adapters f32; sample: {S3_FRAMES} frames, {S3_SECONDS} s of audio in "
            f"{batch['audio_windows'].shape[1]} windows, {n_text} text tokens, "
            f"{tcfg.model_max_length} LM rows")

        # (a) LoRA
        lm_snap = {n: t.detach().to("cpu", copy=True) for n, t in _named_leaves(params["lm"]).items()}
        trainer = Trainer(cfg, tcfg, stage3_params(params), total_steps=2, device=DEVICE)
        n_lora = sum(t.numel() for ab in trainer.lora.values() for t in ab.values())
        n_extra = sum(t.numel() for t in trainer.tx.params) - n_lora
        extras = [k for k in trainer.params
                  if k != "lm" and any(t.requires_grad for t in _leaves(trainer.params[k]))]
        log(f"[11] (a) LoRA: {n_lora} adapter parameters ({len(trainer.lora)} targets x "
            f"{cfg.lm.num_layers} layers), {n_extra} in the trainable extras {extras}")
        n_real = _non_pad_rows(cfg, tcfg, trainer.params, b)
        log(f"[11] (a) spliced sequence: {n_real} non-pad rows of {tcfg.model_max_length}")
        losses_a, counts_a, peak_a = _lora_steps(trainer, batch, "11", n_real)
        profile_stage("11", "(a) LoRA micro-step 5 under torch.profiler",
                      lambda: trainer.train_step(batch))
        moved = [n for n, t in _named_leaves(params["lm"]).items() if not torch.equal(t.cpu(), lm_snap[n])]
        del lm_snap
        log(f"[11] (a) LM base: {len(moved)} leaves changed")
        if moved:
            raise AssertionError(f"[11] the frozen LM changed: {moved[:5]}")

        # (b) flash vs xla on the LoRA view
        _stage3_flash_vs_xla(cfg, trainer, b)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        # (c) K1, K5, K6 at this path's shape
        rows = stage3_kernel_rows(cfg)

        # (d) QLoRA: the frozen base int8
        t0 = time.perf_counter()
        trainer = Trainer(cfg, dataclasses.replace(tcfg, quantize_frozen="int8",
                                                   output_dir=os.path.join(tmp, "d")),
                          stage3_params(params), total_steps=2, device=DEVICE)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        params = None  # the bf16 LM and towers: the int8 trainer holds what it needs
        gc.collect()
        torch.cuda.empty_cache()
        lm = trainer.params["lm"]
        linears = [lm["layers"][k] if k.endswith("proj") else lm["layers"]["mlp"][k]
                   for k in ("q_proj", "k_proj", "v_proj", "o_proj", "gate", "up", "down")]
        linears.append(lm["lm_head"])
        if not all(p["w_q"].dtype == torch.int8 and "w" not in p for p in linears):
            raise AssertionError("[11] (d) the LM linears are not int8")
        del lm, linears
        log(f"[11] (d) QLoRA: the LM's linears and head and both towers int8 in {quant_s:.2f} s; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated with the bf16 base freed")
        losses_d, counts_d, peak_d = _lora_steps(trainer, batch, "11", n_real)
        log(f"[11] (d) losses QLoRA {losses_d} beside LoRA {losses_a}; peak {peak_d:.2f} GiB "
            f"beside {peak_a:.2f} GiB")
        t0 = time.perf_counter()
        merged = trainer.export_merged()
        n_checked, n_same = _check_export_on_host(trainer, merged)
        log(f"[11] (d) export_merged vs dequantize + merge on the host: {n_checked} leaves and "
            f"layer slices held (rtol {S3_EXPORT_RTOL:g}, atol {S3_EXPORT_ATOL:g}; the first, "
            f"middle and last layer of each stacked int8 linear), {n_same} bitwise equal, in "
            f"{time.perf_counter() - t0:.1f} s")
        del trainer, merged, b
        gc.collect()
        torch.cuda.empty_cache()

        # (e) checkpoint, export and the CLI on the cut model
        _stage3_checkpoint_and_cli(cfg, tmp, has_ffmpeg)
    log(f"[11] phase 11 in {time.perf_counter() - t_phase:.1f} s; {card()}")
    return {"lora": counts_a, "qlora": counts_d}, rows


def _stage3_checkpoint_and_cli(full, tmp, has_ffmpeg):
    """(e): on Qwen2-7B(audio) at full width, depths cut to phase 8's: a
    QLoRA Trainer's save restored bitwise by a new Trainer; its export
    written with save_checkpoint_dir and loaded, answering token-identically
    to the merged params in memory; then train.run.main on a synthetic
    data.json, ending with a final/ that loads."""
    from tdc_video_tpu_torch.builder import load_pretrained_model
    from tdc_video_tpu_torch.convert.to_hf import save_checkpoint_dir
    from tdc_video_tpu_torch.eval.runner import TDCPredictor
    from tdc_video_tpu_torch.model import init_tdc
    from tdc_video_tpu_torch.train import run as train_run
    from tdc_video_tpu_torch.train.stages import stage3_audio_lora
    from tdc_video_tpu_torch.train.trainer import Trainer

    cfg = dataclasses.replace(
        full, lm=dataclasses.replace(full.lm, num_layers=CKPT_LAYERS["lm"]),
        siglip=dataclasses.replace(full.siglip, num_layers=CKPT_LAYERS["siglip"]),
        dino=dataclasses.replace(full.dino, num_layers=CKPT_LAYERS["dino"]))
    dev = torch.device(DEVICE)
    log(f"[11] (e) {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated at its start")
    tcfg = dataclasses.replace(stage3_audio_lora(os.path.join(tmp, "e")), quantize_frozen="int8",
                               gradient_accumulation_steps=1, max_steps=2, report_to="none",
                               model_max_length=S3_CUT_T)

    def model(seed):
        return stage3_params(init_tdc(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                                      torch.bfloat16))

    t0 = time.perf_counter()
    tr = Trainer(cfg, tcfg, model(SEED), total_steps=2, device=dev)
    batch = stage3_batch(cfg, S3_CUT_FRAMES, S3_CUT_FRAMES)
    losses = [float(tr.train_step(batch)) for _ in range(2)]
    tr.save()
    saved = os.path.join(tcfg.output_dir, "checkpoints", "2")
    nbytes = sum(os.path.getsize(os.path.join(saved, f)) for f in os.listdir(saved))
    other = Trainer(cfg, tcfg, model(SEED + 1), total_steps=2, device=dev, lora_key=SEED + 2)
    if not other.restore_if_available() or other.step != 2:
        raise AssertionError("[11] (e) no checkpoint restored")
    n_p, diff_p = _compare_trees(other.params, tr.params)
    n_l, diff_l = _compare_trees(other.lora, tr.lora)
    dtypes = sorted({str(t.dtype) for t in _leaves(tr.params)} | {str(t.dtype) for t in _leaves(tr.lora)})
    log(f"[11] (e) cut model (LM {cfg.lm.num_layers}, SigLIP {cfg.siglip.num_layers}, DINOv2 "
        f"{cfg.dino.num_layers} layers), QLoRA losses {losses}; save {nbytes} bytes, restored "
        f"into a new Trainer: {n_p + n_l} leaves ({', '.join(dtypes)}), {len(diff_p + diff_l)} "
        f"differ ({time.perf_counter() - t0:.1f} s)")
    if diff_p or diff_l:
        raise AssertionError(f"[11] (e) restored leaves differ: {(diff_p + diff_l)[:5]}")
    del other

    # the merged export through the reference layout, loaded as the demo loads
    t0 = time.perf_counter()
    merged = _tree_to(tr.export_merged(), lambda x: x.float() if x.is_floating_point() else x)
    del tr
    path = os.path.join(tmp, "merged")
    save_checkpoint_dir(merged, cfg, path)
    _, loaded, _, _ = load_pretrained_model(path, load_tokenizer=False, dtype=torch.bfloat16,
                                            device=dev)
    n_m, diff_m = _compare_trees(loaded.params, merged)
    log(f"[11] (e) {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated with the merged "
        f"export and its loaded copy")
    frames = synth_frames(SEED, S3_CUT_FRAMES)
    ids = []
    for p in (merged, loaded.params):
        pred = TDCPredictor(cfg, p, QwenByteTokenizer(), device_preprocess=True, device=dev)
        pred.answer(frames, QUESTION, max_new_tokens=MAX_NEW_TOKENS)
        ids.append(list(pred.stats.last_ids))
    log(f"[11] (e) export_merged -> save_checkpoint_dir -> load_pretrained_model: config "
        f"{'equal' if loaded.cfg == cfg else 'differs'}, {n_m} leaves, {len(diff_m)} differ; "
        f"answers {ids[1]} (loaded) and {ids[0]} (in memory) ({time.perf_counter() - t0:.1f} s)")
    if diff_m or ids[0] != ids[1] or loaded.cfg != cfg:
        raise AssertionError("[11] (e) the loaded export differs from the merged params")
    del merged, loaded, pred

    # the training entry point on a synthetic data.json
    t0 = time.perf_counter()
    data = os.path.join(tmp, "data")
    os.makedirs(data)
    n, h, w = S3_CLI_FRAMES
    rng = np.random.default_rng(SEED + 12)
    rows = []
    for i in range(2):
        np.save(os.path.join(data, f"v{i}.npy"), rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8))
        row = {"video": f"v{i}.npy", "conversations": train_conversation()[:2]}
        if has_ffmpeg:  # media/io.load_audio decodes through FFmpeg
            _write_wav(os.path.join(data, f"v{i}.wav"), synth_wav(SEED + i, n))
            row["audio"] = f"v{i}.wav"
        rows.append(row)
    with open(os.path.join(data, "data.json"), "w") as fh:
        json.dump(rows, fh)
    out = os.path.join(tmp, "cli")
    argv = ["--stage", "3", "--model_path", path, "--data_path", os.path.join(data, "data.json"),
            "--image_folder", data, "--output_dir", out, "--max_steps", "2", "--report_to", "jsonl",
            "--bert_tokenizer", "", "--max_train_frames", str(n), "--device", DEVICE]
    trainer = train_run.main(argv, tokenizer=QwenByteTokenizer())
    losses = [json.loads(x)["loss"] for x in open(os.path.join(out, "metrics.jsonl"))]
    del trainer
    gc.collect()
    _, final, _, _ = load_pretrained_model(os.path.join(out, "final"), load_tokenizer=False,
                                           device=dev)
    n_final = sum(t.numel() for t in _leaves(final.params))
    log(f"[11] (e) train.run.main --stage 3 --max_steps 2 --report_to jsonl --max_train_frames "
        f"{n} ({'with' if has_ffmpeg else 'without: no FFmpeg libraries for'} a wav per row): "
        f"losses {losses}, checkpoints {sorted(os.listdir(os.path.join(out, 'checkpoints')))}, "
        f"final/ loads ({n_final} params, config {'equal' if final.cfg == cfg else 'differs'}) "
        f"in {time.perf_counter() - t0:.1f} s")
    if len(losses) != 2 or not all(math.isfinite(x) for x in losses) or final.cfg != cfg:
        raise AssertionError("[11] (e) the training entry point did not end as it should")
    del final
    try:
        from torch.utils import tensorboard  # noqa: F401
        tb = "imports"
    except ImportError as e:
        tb = f"does not import ({e})"
    log(f"[11] (e) torch.utils.tensorboard {tb} on this machine")
    gc.collect()
    torch.cuda.empty_cache()


def _write_wav(path: str, wav: np.ndarray) -> None:
    import wave

    with wave.open(path, "wb") as fh:
        fh.setnchannels(1)
        fh.setsampwidth(2)
        fh.setframerate(16000)
        fh.writeframes((np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())


def _compare_trees(a, b, path=""):
    """(leaves compared, paths that differ in structure, dtype or bits)."""
    if isinstance(b, dict):
        if not isinstance(a, dict) or sorted(a) != sorted(b):
            return 0, [path or "/"]
        out = [_compare_trees(a[k], b[k], f"{path}/{k}") for k in b]
    elif isinstance(b, (list, tuple)):
        if not isinstance(a, (list, tuple)) or len(a) != len(b):
            return 0, [path]
        out = [_compare_trees(x, y, f"{path}[{i}]") for i, (x, y) in enumerate(zip(a, b))]
    elif b is None:
        return 0, [] if a is None else [path]
    else:
        same = a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        return 1, [] if same else [path]
    return sum(n for n, _ in out), [p for _, d in out for p in d]


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
    from tdc_video_tpu_torch.media.build import ffmpeg_libraries

    # phase 8's clip leg needs FFmpeg's libraries: asked before any phase runs
    has_ffmpeg, ffmpeg_msg = ffmpeg_libraries()
    log(f"[1] FFmpeg libraries (pkg-config): {'found' if has_ffmpeg else 'not found'}: "
        f"{' | '.join(ffmpeg_msg.splitlines())}")
    from tdc_video_tpu_torch.config import tdc_llama32_3b
    from tdc_video_tpu_torch.eval.runner import prefill_shape

    T, S = prefill_shape(tdc_llama32_3b(), ByteTokenizer(), QUESTION, N_FRAMES, MAX_NEW_TOKENS)
    log(f"[2] main-path prefill shape T={T} S={S}")
    rows = phase_kernels(T, S)
    train_rows = phase_train_kernels()
    cfg, params, pred, frames = phase_main_path(rows)
    phase_flash_vs_xla(cfg, params, pred, frames)
    # K2's device time per launch in encode, beside its `ms` (host work included)
    ms, n = phase_profile(pred, frames)["encode"]["full_attention_nhd"]
    next(r for r in rows if r["name"] == "full_attention_nhd")["device_ms"] = ms / n
    counts10 = phase_serving_options(cfg, params, pred, frames, list(pred.stats.last_ids))
    counts12 = dict(zip(("serve", "chat"), phase_multi_serving(cfg, params, pred, frames)))
    del params, pred
    gc.collect()
    torch.cuda.empty_cache()
    params, counts6 = phase_train(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    n_frames, counts7 = phase_tower_train(cfg, params)
    # launches of each training kernel on its own path, one micro-step: K5/K6
    # in the stage-2 step, K4 in the tower-trainable step
    for r in train_rows:
        r["launches"] = (counts7 if r["name"] == "full_attention" else counts6)[r["name"]]
        if r["launches"] <= 0:
            raise AssertionError(f"kernel {r['name']} was not launched on its path")
    log(f"[7] tower-trainable step ran at {n_frames} frames")
    if n_frames != TOWER_FRAMES:  # K4's row at the shape the path ran
        launches = train_rows[0]["launches"]
        train_rows[0] = k4_row(n_frames)
        train_rows[0]["launches"] = launches
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_counts, demo_counts = phase_checkpoint(has_ffmpeg, ffmpeg_msg)
    for r in rows:  # K1-K3 on phase 8's paths: the loaded checkpoint, the demo where it ran
        r["launches_checkpoint"] = ckpt_counts[r["name"]]
        r["launches_demo"] = None if demo_counts is None else demo_counts[r["name"]]
    gc.collect()
    torch.cuda.empty_cache()
    k1_av, counts_av, av = phase_audio_visual()
    k1_av["launches_av"] = counts_av["flash_kernel"]
    for r in rows + train_rows:  # each kernel's launches on phase 9's and 10's paths
        r["launches_av"] = counts_av[r["name"]]
        for leg, c in counts10.items():
            r[f"launches_{leg}"] = c[r["name"]]
    counts11, s3_rows = phase_stage3(av, has_ffmpeg)
    for r in s3_rows:  # K1, K5, K6 at the stage-3 shape: launches per LoRA micro-step
        r["launches"] = counts11["lora"][r["name"]]
    for r in rows + train_rows + [k1_av] + s3_rows:  # each kernel on phase 11's and 12's legs
        for leg, c in list(counts11.items()) + list(counts12.items()):
            r[f"launches_{leg}"] = c[r["name"]]
    print(json.dumps({"kernels": rows + train_rows + [k1_av] + s3_rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
