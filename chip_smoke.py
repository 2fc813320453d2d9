#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dlrover_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from dlrover_tpu_torch/csrc (nvcc, at first use),
then runs, in order, failing on the first phase that fails:

1. device: the card's name and power limit, as nvidia-smi reports them;
2. kernels vs plain versions: each flash attention kernel (forward, dQ,
   dK/dV) against its plain PyTorch version on the same inputs, at small
   shapes (causal and not, GQA 4:2, head_dim 64 and 128) and at the
   training shape (B=4, S=2048, H=16, D=128); forward within 3e-2 absolute
   (LSE 1e-3), gradients within 0.05 * max|plain|, and every output, on
   every tile of 64 sequence positions, within a relative error
   ||kernel - plain||_F / ||plain||_F of 1e-2.  Then a small Llama's
   logits through the flash kernels against the reference attention core;
3. kernel timing at the training shape with CUDA events, beside each
   kernel's bound on an H100 (bytes over 3.35 TB/s, bf16 operations over
   989 TFLOP/s), its plain version and F.scaled_dot_product_attention
   (timed here only, as a yardstick; the port never calls it);
4. training: Llama-2-1B at full width and depth (22 layers), flash
   attention, B=4, S=2048 from a seeded numpy batch, AdamW with bf16
   moments, bf16 grads on fp32 masters; one warm-up step and 4 timed
   steps, each with a finite loss and the kernel launch counts a step
   must make (2 forwards per layer with remat, one dQ and one dK/dV);
   then one more step under torch.profiler for the device time by phase
   and by kernel family, and the device's busy share.

The last three lines are the kernels' JSON record, the nvidia-smi line and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""

import json
import math
import re
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FWD_ATOL = 3e-2
LSE_ATOL = 1e-3
GRAD_REL = 0.05
# ||kernel - plain||_F / ||plain||_F on each tile of REL_TILE sequence
# positions, the largest over the tiles.  The max-abs limits above are set
# by the largest values (the early causal rows); this one holds every tile,
# the late rows' small values too.  bf16 rounding of the outputs alone
# gives a few 1e-3.
REL_TOL = 1e-2
REL_TILE = 64
TRAIN_B, TRAIN_S, TIMED_STEPS = 4, 2048, 4
SOURCE = "dlrover_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "dlrover_tpu/ops/pallas/flash_attention.py:64",
    "flash_bwd_dq": "dlrover_tpu/ops/pallas/flash_attention.py:195",
    "flash_bwd_dkv": "dlrover_tpu/ops/pallas/flash_attention.py:239",
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rand_qkv(gen, B, S, H, H_kv, D):
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    return rnd(B, S, H, D), rnd(B, S, H_kv, D), rnd(B, S, H_kv, D), \
        rnd(B, S, H, D)


def check_kernels(fa, gen, B, S, H, H_kv, D, causal):
    """Each kernel against its plain version; returns, per kernel, its
    largest absolute error, that error's limit and its relative error."""
    import torch

    q, k, v, do = rand_qkv(gen, B, S, H, H_kv, D)
    out, lse = fa.flash_forward(q, k, v, causal)
    ref_out, ref_lse = fa.flash_forward_plain(q, k, v, causal)
    delta = fa.attention_delta(ref_out, do)
    dq = fa.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta, causal)
    torch.cuda.synchronize()
    ref_dq = fa.flash_bwd_dq_plain(q, k, v, do, ref_lse, delta, causal)
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, ref_lse, delta,
                                            causal)

    def compare(got, want, atol):
        # sequence positions are dim 1 of [B, S, H, D] and of [B*H, S]
        diff, want = got.float() - want.float(), want.float()
        rel = max((d.norm() / w.norm()).item() for d, w in zip(
            diff.split(REL_TILE, dim=1), want.split(REL_TILE, dim=1)))
        return diff.abs().max().item(), atol, rel

    def grad_tol(ref):
        return GRAD_REL * max(1.0, ref.float().abs().max().item())

    errors = {
        "flash_fwd": compare(out, ref_out, FWD_ATOL),
        "flash_fwd_lse": compare(lse, ref_lse, LSE_ATOL),
        "flash_bwd_dq": compare(dq, ref_dq, grad_tol(ref_dq)),
        "flash_bwd_dk": compare(dk, ref_dk, grad_tol(ref_dk)),
        "flash_bwd_dv": compare(dv, ref_dv, grad_tol(ref_dv)),
    }
    shape = f"B={B} S={S} H={H} H_kv={H_kv} D={D} causal={causal}"
    for name, (e, tol, rel) in errors.items():
        print(f"  {shape} {name}: max_abs_err={e:.3e} tol={tol:.3e} "
              f"rel_err={rel:.3e} rel_tol={REL_TOL:.0e}")
        if not (e <= tol and rel <= REL_TOL):
            raise AssertionError(
                f"{name} disagrees with its plain version at {shape}: "
                f"max abs {e} (tol {tol}), relative {rel} (tol {REL_TOL})")
    dk_e, dv_e = errors["flash_bwd_dk"], errors["flash_bwd_dv"]
    return {
        "flash_fwd": errors["flash_fwd"],
        "flash_bwd_dq": errors["flash_bwd_dq"],
        "flash_bwd_dkv": (*max(dk_e[:2], dv_e[:2], key=lambda x: x[0] / x[1]),
                          max(dk_e[2], dv_e[2])),
    }


def check_model_logits():
    """A small Llama on the card: logits through the flash kernels against
    the reference attention core (same weights, bf16 compute)."""
    import torch

    from dlrover_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    base = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64)
    flash = LlamaForCausalLM(LlamaConfig(attention_impl="flash", **base),
                             device="cuda", seed=1)
    ref = LlamaForCausalLM(LlamaConfig(attention_impl="reference", **base),
                           device="cuda", seed=1)
    ids = torch.randint(0, 512, (2, 256), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(2))
    with torch.no_grad():
        got, want = flash(ids), ref(ids)
    e = (got - want).abs().max().item()
    # two bf16 paths that round probabilities at different points; the
    # CPU tests bound bf16 model drift by 1e-1 on O(1) logits the same way
    print(f"  small llama logits, flash vs reference: max_abs_err={e:.3e} "
          f"tol=1.000e-01 shape={tuple(got.shape)}")
    if not (torch.isfinite(got).all() and e <= 1e-1):
        raise AssertionError("flash logits disagree with the reference")


def attention_work(B, S, H, D, causal):
    """(score pairs, bytes of one [B,S,H,D] bf16 tensor, bytes of one
    [B*H,S] fp32 residual)."""
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    return pairs, B * S * H * D * 2, B * H * S * 4


def bound_ms(flops, nbytes):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_kernels(fa, gen):
    import torch
    import torch.nn.functional as F

    B, S, H, D = TRAIN_B, TRAIN_S, 16, 128
    q, k, v, do = rand_qkv(gen, B, S, H, H, D)
    out, lse = fa.flash_forward(q, k, v, True)
    delta = fa.attention_delta(out, do)
    pairs, t_bytes, r_bytes = attention_work(B, S, H, D, True)
    runs = {
        # name: (kernel, plain, flops, bytes read + written)
        "flash_fwd": (
            lambda: fa.flash_forward(q, k, v, True),
            lambda: fa.flash_forward_plain(q, k, v, True),
            4 * D * pairs, 4 * t_bytes + r_bytes),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
            lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, True),
            6 * D * pairs, 5 * t_bytes + 2 * r_bytes),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
            lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True),
            8 * D * pairs, 6 * t_bytes + 2 * r_bytes),
    }
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_fwd_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        iters=20)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True).backward(
            dot)

    sdpa_fwd_bwd_ms = cuda_time_ms(sdpa_fwd_bwd, iters=10)
    timings = {}
    for name, (kernel, plain, flops, nbytes) in runs.items():
        ms = cuda_time_ms(kernel, iters=20)
        plain_ms = cuda_time_ms(plain, iters=3, warmup=1)
        b_ms, b_by = bound_ms(flops, nbytes)
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by,
                             library_ms=sdpa_fwd_ms
                             if name == "flash_fwd" else None)
        print(f"  {name}: {ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}, "
              f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)  "
              f"plain {plain_ms:.4f} ms")
    print(f"  F.scaled_dot_product_attention(is_causal=True): forward "
          f"{sdpa_fwd_ms:.4f} ms, forward+backward {sdpa_fwd_bwd_ms:.4f} ms;"
          f" port forward+dQ+dK/dV "
          f"{sum(t['ms'] for t in timings.values()):.4f} ms")
    return timings


def train(fa):
    import numpy as np
    import torch

    from dlrover_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from dlrover_tpu_torch.trainer.optim import create_optimizer
    from dlrover_tpu_torch.trainer.train import Trainer

    cfg = LlamaConfig.llama2_1b(max_seq_len=TRAIN_S, attention_impl="flash")
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    n_params = model.num_params()
    trainer = Trainer(
        model,
        create_optimizer(peak_lr=3e-4, warmup_steps=10, total_steps=10_000,
                         moment_dtype=torch.bfloat16),
        grads_dtype=torch.bfloat16, device="cuda",
    )
    state = trainer.create_state()
    ids = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(TRAIN_B, TRAIN_S + 1))
    batch = {"input_ids": ids[:, :-1].astype(np.int32),
             "labels": ids[:, 1:].astype(np.int32)}
    per_step = {"flash_fwd": 2 * cfg.num_layers,
                "flash_bwd_dq": cfg.num_layers,
                "flash_bwd_dkv": cfg.num_layers}
    print(f"  llama2_1b: {n_params / 1e9:.3f}B params, {cfg.num_layers} "
          f"layers, hidden {cfg.hidden_size}, heads {cfg.num_heads}x"
          f"{cfg.head_dim}, vocab {cfg.vocab_size}; B={TRAIN_B} S={TRAIN_S}")
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    torch.cuda.synchronize()
    fa.reset_launches()
    for step in range(1 + TIMED_STEPS):
        before = dict(fa.launches)
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        loss = metrics["loss"].item()
        grad_norm = metrics["grad_norm"].item()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        grown = {k: fa.launches[k] - before[k] for k in per_step}
        print(f"  step {step}{' (warm-up)' if step == 0 else ''}: "
              f"loss={loss:.4f} grad_norm={grad_norm:.4f} "
              f"{dt * 1e3:.1f} ms launches={grown}")
        if not math.isfinite(loss) or not math.isfinite(grad_norm):
            raise AssertionError(f"non-finite loss/grad_norm at step {step}")
        if grown != per_step:
            raise AssertionError(f"step {step} launched {grown}, expected "
                                 f"{per_step}")
        if step == 0 and abs(loss - math.log(cfg.vocab_size)) > 2.0:
            # random weights and tokens: the loss starts near ln(vocab)
            raise AssertionError(f"first loss {loss} is far from "
                                 f"ln({cfg.vocab_size})")
        if step:
            step_s.append(dt)
    mean_s = sum(step_s) / len(step_s)
    state = profile_step(trainer, state, batch, fa, per_step, mean_s)
    launches = dict(fa.launches)
    tokens = TRAIN_B * TRAIN_S
    L, h = cfg.num_layers, cfg.num_heads * cfg.head_dim
    flops_per_step = (6 * n_params + 6 * L * h * TRAIN_S) * tokens
    print(f"  step_ms={mean_s * 1e3:.2f} (mean of {len(step_s)}; "
          f"min {min(step_s) * 1e3:.2f}) tokens_per_s={tokens / mean_s:.0f}"
          f" mfu={flops_per_step / mean_s / PEAK_BF16_FLOPS:.4f} "
          f"[(6N + 6*L*h*S)*tokens / 989e12, remat not counted] "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 2**30:.2f}")
    return launches


def profile_step(trainer, state, batch, fa, per_step, step_s):
    """One more step under torch.profiler: the device's busy share of the
    step, device time by phase and by kernel family, the top kernels."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    before = dict(fa.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, metrics = trainer.train_step(state, batch)
        metrics["loss"].item()
        torch.cuda.synchronize()
    grown = {k: fa.launches[k] - before[k] for k in per_step}
    if grown != per_step:
        raise AssertionError(f"profiled step launched {grown}")
    # device-side events, less the GPU images of the trainer's spans
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("trainer.")]
    if not kernels:
        raise AssertionError("the profiler saw no device activity")
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    families = collections.Counter()
    for name, ms in by_name.items():
        low = name.lower()
        if "fa_fwd_kernel" in low:
            families["flash_fwd kernel"] += ms
        elif "fa_bwd_dq_kernel" in low:
            families["flash_bwd_dq kernel"] += ms
        elif "fa_bwd_dkv_kernel" in low:
            families["flash_bwd_dkv kernel"] += ms
        elif any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma")):
            families["cuBLAS matmul"] += ms
        else:
            families["other (elementwise, reductions, copies)"] += ms
    busy_ms = sum(by_name.values())
    # a CPU span's device time counts the kernels its own thread launched:
    # the forward under trainer.forward_backward (the backward, remat
    # recompute included, runs on autograd's device thread) and the whole
    # optimizer update under trainer.update
    spans = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
             if e.key.startswith("trainer.")}
    forward = spans.get("trainer.forward_backward", 0.0)
    update = spans.get("trainer.update", 0.0)
    print(f"  profiled step: device busy {busy_ms:.1f} ms = "
          f"{busy_ms / (step_s * 1e3):.3f} of the {step_s * 1e3:.1f} ms step"
          f" (idle share {1 - busy_ms / (step_s * 1e3):.3f})")
    print(f"    forward {forward:.1f} ms, backward with remat recompute "
          f"{busy_ms - forward - update:.1f} ms, optimizer update "
          f"{update:.1f} ms")
    for family, ms in families.most_common():
        print(f"    {family}: {ms:.1f} ms ({ms / busy_ms:.3f} of busy)")
    for name, ms in by_name.most_common(8):
        print(f"    top kernel {ms:8.2f} ms  {name[:100]}")
    return state


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from dlrover_tpu_torch.ops.cuda import _build
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa

    print(f"[device] {card_line()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    kernel = None
    for line in _build.build_log(fa.KERNEL_SOURCE).splitlines():
        found = re.search(r"(fa_\w+?_kernel)ILi(\d+)E", line)
        if "Compiling entry function" in line and found:
            kernel = f"{found.group(1)}<{found.group(2)}>"
        elif kernel and ("registers" in line or "spill" in line):
            print(f"  {kernel}: {line.split(':', 1)[-1].strip()}")

    print("[kernels vs plain versions]", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for D in (64, 128):
        for causal in (True, False):
            check_kernels(fa, gen, 2, 256, 4, 2, D, causal)
    check_kernels(fa, gen, 1, 200, 4, 4, 128, True)  # ragged last tile
    errors = check_kernels(fa, gen, TRAIN_B, TRAIN_S, 16, 16, 128, True)
    check_model_logits()

    print("[kernel timing, B=4 S=2048 H=16 D=128 causal]", flush=True)
    timings = time_kernels(fa, gen)

    print("[training]", flush=True)
    launches = train(fa)

    record = [
        dict(name=name, route="cuda", source=SOURCE,
             replaces=REPLACES[name], launches=launches[name],
             max_abs_err=errors[name][0], atol=errors[name][1],
             rel_err=errors[name][2], rel_tol=REL_TOL,
             **timings[name])
        for name in REPLACES
    ]
    print(json.dumps({"kernels": record}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
