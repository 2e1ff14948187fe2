"""Host time of one call of the launch wrappers of K4, K5, K6 and K6's
backward on the card, at shapes small enough that the launch, not the
kernel, bounds a call.

For each wrapper, ``CALLS`` calls are enqueued back to back, ``REPEATS``
times: ``host_us`` is the time a call takes to return (the clock read
before the closing synchronize; ``CALLS`` times three launches stay well
inside the device's queue, so the host is never held back by it), and
``wall_us`` the time a call takes to complete (through the synchronize).
The minimum and the median over the repeats are printed.

Where the checkout's wrappers launch either straight or through their
``torch.library`` operators (``kernels/common.py::launch_directly``), both
routes are timed on the same inputs: ``direct`` is what a plain run on the
card takes, ``operator`` what a counted run or a trace takes (forced here
by patching the route's choice), and their outputs are compared.  A
checkout whose wrappers have one route reports it as ``default``; so the
script also times an older checkout, with that checkout's ``src`` on
``PYTHONPATH``.

Usage, from the root of a checkout on a machine with a CUDA GPU::

    PYTHONPATH=src python3 src/repro_torch/benchmarks/wrapper_overhead.py

Prints the card's name and power limit, then one JSON line a (wrapper,
route).  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import importlib
import json
import statistics
import subprocess
import sys
import time

CALLS, REPEATS = 200, 20
#: the ops modules whose wrappers choose a route
OPS = ("repro_torch.kernels.flash_attention.ops",
       "repro_torch.kernels.ssm_scan.ops", "repro_torch.kernels.slstm.ops")


def cases(torch):
    """(wrapper, shape, call) at launch-bound shapes: K4 B1 H4 KV2 S128 D64
    bf16 causal; K5 BH2 S64 DK32 DV32 fp32 (chip_smoke.py's smallest); K6
    and its backward at B1 S300 W20 (chip_smoke.py's ragged shape)."""
    from repro_torch.kernels import (flash_attention_cuda,
                                     slstm_scan_bwd_cuda, slstm_scan_cuda,
                                     ssm_scan_cuda)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    bf16 = torch.bfloat16
    q, k, v = (rand(1, n, 128, 64, dtype=bf16) for n in (4, 2, 2))
    sq, sk, sv = (rand(1, 2, 64, 32) * 0.3 for _ in range(3))
    la = -torch.rand(1, 2, 64, device="cuda", generator=gen) * 0.1
    z, i, f, o = (rand(1, 300, 20) for _ in range(4))
    _, c, n, m = slstm_scan_cuda(z, i, f, o, states=True)
    dy = rand(1, 300, 20)
    return [
        ("flash_attention_cuda", [1, 4, 2, 128, 64],
         lambda: flash_attention_cuda(q, k, v, causal=True)),
        ("ssm_scan_cuda", [2, 64, 32, 32],
         lambda: ssm_scan_cuda(sq, sk, sv, la)),
        ("slstm_scan_cuda", [1, 300, 20],
         lambda: slstm_scan_cuda(z, i, f, o)),
        ("slstm_scan_bwd_cuda", [1, 300, 20],
         lambda: slstm_scan_bwd_cuda(z, i, f, o, c, n, m, dy)),
    ]


def routes():
    """{route: the ops modules' ``launch_directly`` to install} (None: leave
    the checkout's wrappers as they are)."""
    common = importlib.import_module("repro_torch.kernels.common")
    if not hasattr(common, "launch_directly"):
        return {"default": None}
    return {"direct": common.launch_directly,
            "operator": lambda x: False}


def per_call(torch, fn):
    """(host µs, wall µs) of one call, over ``CALLS`` calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / CALLS * 1e6, (t2 - t0) / CALLS * 1e6


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("wrapper_overhead: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    from repro_torch.kernels import _build
    _build.extension()
    mods = [importlib.import_module(name) for name in OPS]
    outputs = {}
    for route, choose in routes().items():
        if choose is not None:
            for mod in mods:
                mod.launch_directly = choose
        for name, shape, fn in cases(torch):
            out = fn()
            outputs.setdefault(name, out)
            same = all(torch.equal(a, b) for a, b in zip(
                out if isinstance(out, tuple) else (out,),
                outputs[name] if isinstance(outputs[name], tuple)
                else (outputs[name],)))
            for _ in range(3):
                fn()
            runs = [per_call(torch, fn) for _ in range(REPEATS)]
            host, wall = zip(*runs)
            print(json.dumps({
                "wrapper": name, "route": route, "shape": shape,
                "calls": CALLS, "repeats": REPEATS,
                "host_us_min": min(host),
                "host_us_median": statistics.median(host),
                "wall_us_min": min(wall),
                "wall_us_median": statistics.median(wall),
                "same_output_as_first_route": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
