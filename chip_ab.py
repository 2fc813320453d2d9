#!/usr/bin/env python3
"""Time CUDA kernel variants of the port against each other on one GPU.

    python3 chip_ab.py [--flash NAME=SOURCE ...] [--add NAME=SOURCE ...]
                       [--edit NAME OLD NEW ...] [--rounds N]

A variant is a CUDA source file: ``--flash`` takes a flash_attention.cu,
``--add`` a ring_reduce_scatter.cu (``dlrover_tpu_torch/csrc/`` or a copy,
e.g. a parent commit's unpacked under ``build/``).  ``--edit NAME OLD NEW``
replaces the text OLD by NEW in a copy of NAME's source (a tile size, a
ring depth; it must occur).  Every variant is built with nvcc and the port's
flags into its own library under ``build/ab/``, all at once, beside the
``*.cuh`` headers of its source's directory; the build prints each flash
kernel's registers and spills and its SASS counts.

A flash variant is loaded in place of the port's library and checked
against the plain versions at every shape of ``chip_smoke.FLASH_SHAPES``
(both tolerances); one that fails is not timed.  Then, per round, the
dQ, forward and dK/dV of every variant are timed with CUDA events at B=4
S=2048 H=16 D=128 causal, each kernel's variants in turns (a, b, ..., b,
a), beside SDPA's backward alone.  An add variant's hop add must be ``torch.equal`` to its
plain version at ``chip_smoke.ADD_WIDTHS``, in and out of place; then it
is timed at the dp leg's largest row in turns with ``torch.add``, in place
(``out=a``) and out of place.  Needs one CUDA device; prints the card's
``nvidia-smi`` line first.
"""

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import chip_smoke as smoke

AB_DIR = Path(__file__).resolve().parent / "build" / "ab"


def build_variants(variants: dict, edits: dict) -> dict:
    """{name: library path} of every variant that built; nvcc's report of
    each is printed."""
    from dlrover_tpu_torch.ops.cuda import _build

    running = {}
    for name, source in variants.items():
        source = Path(source)
        out_dir = AB_DIR / name
        out_dir.mkdir(parents=True, exist_ok=True)
        for header in source.parent.glob("*.cuh"):
            (out_dir / header.name).write_text(header.read_text())
        text = source.read_text()
        for old, new in edits.get(name, []):
            if old not in text:
                raise ValueError(f"{name}: {old!r} is not in {source}")
            text = text.replace(old, new)
        src = out_dir / source.name
        src.write_text(text)
        lib = out_dir / f"lib{source.stem}.so"
        running[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in running.items():
        log = proc.communicate()[0]
        print(f"[build {name}] rc {proc.returncode}", flush=True)
        smoke.print_build_report(log)
        if proc.returncode:
            print(log[-3000:])
            continue
        if lib.stem == "libflash_attention":
            for kernel, ops in smoke.sass_counts(_build, lib).items():
                print(f"  {kernel} SASS: {ops}")
        built[name] = lib
    return built


def load(lib_path, signatures: dict):
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def using(module, lib, fn):
    """``fn`` run with ``module``'s kernels taken from ``lib``."""
    def call():
        module._lib = lib
        return fn()
    return call


def flash_ab(fa, libs: dict, rounds: int) -> None:
    import torch
    import torch.nn.functional as F

    good = {}
    for name, path in libs.items():
        fa._lib = load(path, fa._SIGNATURES)
        gen = torch.Generator(device="cuda").manual_seed(0)
        print(f"[{name}: kernels vs plain versions]", flush=True)
        try:
            for shape in smoke.FLASH_SHAPES:
                smoke.check_kernels(fa, gen, *shape)
        except AssertionError as e:
            print(f"  {name} FAILED: {e}")
            continue
        good[name] = fa._lib
    if not good:
        return
    B, S, H, D = smoke.TRAIN_B, smoke.TRAIN_S, 16, 128
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = smoke.rand_qkv(gen, B, S, H, H, D)
    out, lse = fa.flash_forward_plain(q, k, v, True)
    delta = fa.attention_delta(out, do)
    qg, kg, vg = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        sdpa_out, (qg, kg, vg), do.transpose(1, 2), retain_graph=True)
    kernels = {
        "dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
        "fwd": lambda: fa.flash_forward(q, k, v, True),
        "dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
    }
    print(f"[timing at B={B} S={S} H={H} D={D} causal, in turns]",
          flush=True)
    readings = {name: {kern: [] for kern in kernels} for name in good}
    for r in range(rounds):
        print(f"  round {r}: SDPA backward alone "
              f"{smoke.cuda_time_ms(sdpa_bwd, iters=10):.4f} ms")
        for kern, fn in kernels.items():
            got = smoke.time_in_turns(
                {name: using(fa, lib, fn) for name, lib in good.items()})
            print(f"  round {r} {kern}: " + "; ".join(
                f"{name} {', '.join(f'{t:.4f}' for t in ts)}"
                for name, ts in got.items()), flush=True)
            for name, ts in got.items():
                readings[name][kern] += ts
    for name, by_kernel in readings.items():
        print(f"  mean {name}: " + "  ".join(
            f"{kern} {statistics.mean(ts):.4f}"
            for kern, ts in by_kernel.items()))


def add_ab(rrs, libs: dict, rounds: int) -> None:
    import torch

    signatures = {fn: argtypes for fn, argtypes in rrs._FUNCTIONS.values()}
    good = {}
    for name, path in libs.items():
        rrs._lib = load(path, signatures)
        try:
            smoke.check_ring_add(rrs, {})
        except AssertionError as e:
            print(f"  {name} FAILED: {e}")
            continue
        print(f"  {name}: hop add equal to plain, in and out of place")
        good[name] = rrs._lib
    width = smoke.DP_LARGEST_ROW
    a = torch.randn(width, device="cuda")
    b = torch.randn(width, device="cuda")
    print(f"[hop add at width {width}, in turns]", flush=True)
    for label, torch_fn, kernel_fn in (
            ("in place", lambda: torch.add(a, b, out=a),
             lambda: rrs.ring_add(a, b, out=a)),
            ("out of place", lambda: torch.add(a, b),
             lambda: rrs.ring_add(a, b))):
        fns = {"torch": torch_fn, **{name: using(rrs, lib, kernel_fn)
                                     for name, lib in good.items()}}
        readings = {name: [] for name in fns}
        for _ in range(rounds):
            for name, ts in smoke.time_in_turns(fns).items():
                readings[name] += ts
        print(f"  {label}: " + "; ".join(
            f"{name} {statistics.mean(ts):.4f} ms "
            f"({', '.join(f'{t:.4f}' for t in ts)})"
            for name, ts in readings.items()), flush=True)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--flash", action="append", default=[])
    parser.add_argument("--add", action="append", default=[])
    parser.add_argument("--edit", nargs=3, action="append", default=[],
                        metavar=("NAME", "OLD", "NEW"))
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    from dlrover_tpu_torch.ops.cuda import flash_attention as fa
    from dlrover_tpu_torch.ops.cuda import ring_reduce_scatter as rrs

    print(smoke.card_line(), flush=True)
    flash = dict(v.split("=", 1) for v in args.flash)
    add = dict(v.split("=", 1) for v in args.add)
    edits = {}
    for name, old, new in args.edit:
        edits.setdefault(name, []).append((old, new))
    built = build_variants({**flash, **add}, edits)
    flash_ab(fa, {n: p for n, p in built.items() if n in flash}, args.rounds)
    if add:
        add_ab(rrs, {n: p for n, p in built.items() if n in add},
               args.rounds)
    print("AB_DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
