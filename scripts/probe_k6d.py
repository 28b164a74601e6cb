#!/usr/bin/env python3
"""Time K6d (``l1_norm``) at its shapes on one NVIDIA GPU, beside its bound,
its plain version and the launch floor (an empty kernel), with K5, K6a, K6b
and K7a as guards, and K3 / K4 (``gmm1_ring`` / ``gmm2_combine_ring``) at a
prefill chunk's shape.

    python3 scripts/probe_k6d.py [--out probe.json] [--only k6d guard k3k4 sweep regs]
                                 [--against other.json]

Run from a repository root (or with it on ``sys.path``): the cases go through
that tree's wrappers and ``chip_smoke`` helpers (the timer evicts the L2 and
spins the device before every launch and takes the median), so the same
script times two trees in one call: unpack the parent with ``git archive``
into a git-ignored directory and run change, change, parent, parent.
``--against`` another run's JSON prints whether each case's SHA-256 digests
equal that run's.  Random inputs from seeds:

- ``k6d``: K6d at ``[512, 4096]`` and ``[8, 4096]`` in bf16 and f32,
  ``[2048, 4096]`` bf16 and ``[3, 4097]`` (the element path), N(0.5, 1)
  rows: within 1e-5 of the largest value of ``l1_norm_ref``, bit-equal to
  ``l1_norm_rows_plain`` where the tree has it; digests of the output;
- ``guard``: ``probe_k7a_k6b.py``'s K7a and K6b / K6c cases and its guards
  (K5 at ``[8, 16384]`` and ``[2048, 7168]``, K6a at ``[512, 2880]``):
  times and digests, which must not move (their code is unchanged);
- ``k3k4`` (not run by default): K3 and K4 at DeepSeek-V3's published widths
  (256 experts, hidden 7168, intermediate 2048, top-8) on one layer's random
  W8A8 experts at a 64-token prefill chunk and at 70 tokens (a chunk with
  a few decode rows), through ``chip_smoke.check_gmm`` (held to their plain
  versions, timed, bytes bound);
- ``sweep`` (not run by default; the change's tree only): K6d's launch
  plans around ``ops/row_reduce.l1_plan``'s through the C launcher at
  ``[512, 4096]``, ``[2048, 4096]`` and ``[8, 4096]`` bf16 and ``[512,
  4096]`` f32: vectors of 16 bytes of the f32 output (4 elements, an
  8-byte load of bf16), one, two, four or eight vectors a thread, one, two
  or four rows a block, each plan bit-equal to ``l1_norm_rows_plain`` on it;
- ``regs`` (not run by default): ``nvcc -Xptxas -v`` of ``csrc/norm.cu``:
  registers, stack and spills of every K6d instance.

Prints one line a case and the card, and writes the numbers as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path.cwd()))
sys.path.insert(1, str(pathlib.Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402  (exits without a GPU)
import probe_k7a_k6b as p7  # noqa: E402
import torch  # noqa: E402

K6D_CASES = ((512, 4096, torch.bfloat16), (512, 4096, torch.float32), (8, 4096, torch.bfloat16),
             (8, 4096, torch.float32), (2048, 4096, torch.bfloat16), (3, 4097, torch.bfloat16))
K3K4_TOKENS = (64, 70)


def k6d():
    out = {}
    n = cs.norm
    for rows, h, dtype in K6D_CASES:
        gen = torch.Generator(device=cs.DEV).manual_seed(rows + h)
        x = (torch.randn((rows, h), generator=gen, device=cs.DEV) + 0.5).to(dtype)
        got, want = n.l1_norm(x), n.l1_norm_ref(x)
        torch.cuda.synchronize()
        err = cs.max_abs(got, want)
        mirror = None
        if hasattr(n, "l1_norm_rows_plain"):
            plan = cs.norm.l1_launch_plan(x, got)
            mirror = bool(torch.equal(got.cpu(), n.l1_norm_rows_plain(x.cpu(), plan)))
        r = dict(err=err, close_to_plain=err <= 1e-5 * float(want.abs().max()),
                 bit_equal_to_mirror=mirror, ms=cs.time_ms(lambda: n.l1_norm(x), 50),
                 plain_ms=cs.time_ms(lambda: n.l1_norm_ref(x), 20),
                 bound_ms=cs.bound(rows * h * (x.element_size() + 4), 2 * rows * h,
                                   cs.F32_FLOPS)[0],
                 digests=[cs.digest(got)])
        key = f"[{rows}, {h}] {str(dtype)[6:]}"
        cs.log(f"  K6d {key}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
               f"{r['bound_ms']:.5f}); max|err| {err:.3e}, bit-equal to the mirror {mirror}; "
               f"digests {r['digests']}")
        out[key] = r
    return out


def guards():
    out = {f"K7a {k}": v for k, v in p7.k7a().items()}
    out.update(p7.k6b())
    out.update({k: v for k, v in p7.guards().items() if not k.startswith("K6d")})
    return out


def k3k4():
    """K3 / K4 on one layer's W8A8 experts at published widths."""
    moe = cs.m.init_quantized_experts(dataclasses.replace(cs.CFG, num_layers=1), cs.SEED + 1)[0]
    out = {}
    for n_tok in K3K4_TOKENS:
        gen = torch.Generator(device=cs.DEV).manual_seed(n_tok)
        g1, g2 = cs.check_gmm(gen, moe, n_tok, cs.CFG.topk, True, f"K3 / K4 at {n_tok} tokens")
        for name, r in (("K3", g1), ("K4", g2)):
            cs.log(f"    {name} {n_tok} tokens: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
                   f"bound {r['bound_ms']:.4f} {r['bound_by']}, "
                   f"{100 * r['bound_ms'] / r['ms']:.0f} % of it)")
            out[f"{name} {n_tok} tokens"] = r
    del moe
    torch.cuda.empty_cache()
    return out


def _l1_plans(rows, h):
    """The wrapper's plan and its neighbours, on vectors of 16 bytes of the
    output (4 elements)."""
    rr = cs.row_reduce
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {rr.l1_plan(rows, h, sms)} if hasattr(rr, "l1_plan") else set()
    for c in ((1, 2) if rows <= 8 else (1,)):
        per = -(-h // 4 // c)
        for tv in (1, 2, 4, 8):
            t = min(512, max(32, -(-(-(-per // tv)) // 32) * 32))
            for br in ((1, 2, 4) if c == 1 and rows > 8 else (1,)):
                out.add(rr.RowPlan(c, t, -(-per // t), 4, br))
    return sorted(out)


def sweep():
    lib = cs.cuda_lib.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for rows, h, dtype in ((512, 4096, torch.bfloat16), (2048, 4096, torch.bfloat16),
                           (8, 4096, torch.bfloat16), (512, 4096, torch.float32)):
        gen = torch.Generator(device=cs.DEV).manual_seed(rows + h)
        x = (torch.randn((rows, h), generator=gen, device=cs.DEV) + 0.5).to(dtype)
        y = torch.empty((rows, h), device=cs.DEV)
        bf16 = int(dtype == torch.bfloat16)

        def launch(name, plan):
            cs.cuda_lib.check(lib, lib.l1_norm_launch(x.data_ptr(), y.data_ptr(), rows, h, bf16,
                                                      *plan, stream), name)
        plans = []
        for plan in _l1_plans(rows, h):
            launch("kernel", plan)
            torch.cuda.synchronize()
            same = torch.equal(y.cpu(), cs.norm.l1_norm_rows_plain(x.cpu(), plan))
            plans.append((f"kernel (bit-equal {same})", plan))
        p7._timed(out, f"K6d [{rows}, {h}] {str(dtype)[6:]}", plans,
                  lambda name, plan: launch(name, plan))
    return out


def regs():
    """``nvcc -Xptxas -v`` of norm.cu: each K6d instance's registers, stack
    and spill lines, demangled."""
    lib = cs.cuda_lib
    out = {}
    with tempfile.TemporaryDirectory() as work:
        p = subprocess.run([lib._nvcc(), *lib._NVCC_FLAGS, "-Xptxas", "-v", "-I",
                            str(lib._SRC_DIR), "-c", str(lib._SRC_DIR / "norm.cu"), "-o",
                            str(pathlib.Path(work) / "x.o")],
                           capture_output=True, text=True, check=True)
        name = None
        for line in (p.stderr + p.stdout).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
            elif name and "l1_norm_kernel" in name and re.search(
                    r"registers|spill|stack frame", line):
                out.setdefault(name, []).append(line.split("ptxas info    :")[-1].strip())
    filt = pathlib.Path(lib._nvcc()).with_name("cu++filt")
    names = list(out)
    if filt.exists() and names:
        plain = subprocess.run([str(filt), *names], capture_output=True, text=True).stdout
        out = {d: out[n] for n, d in zip(names, plain.splitlines())}
    for k, v in out.items():
        cs.log(f"  {k}: {'; '.join(v)}")
    return out


def compare(res, other):
    """Whether each case's digests equal the other run's."""
    same = {}
    for group in ("k6d", "guard"):
        for k, v in res.get(group, {}).items():
            o = other.get(group, {}).get(k)
            if o is not None:
                same[f"{group} {k}"] = v["digests"] == o["digests"]
    for k, v in same.items():
        cs.log(f"  digests equal to the other run's, {k}: {v}")
    return same


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the numbers here as JSON")
    ap.add_argument("--only", nargs="+", choices=("k6d", "guard", "k3k4", "sweep", "regs"),
                    default=("k6d", "guard"), help="these cases alone (with the launch floor)")
    ap.add_argument("--against", default=None, help="another run's JSON: compare the digests")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(card)
    cs.log(f"tree: {pathlib.Path(cs.__file__).resolve().parent}")
    cs.cuda_lib.load_library()
    res = {"card": card, "launch_floor_ms": p7.launch_floor()}
    for name, fn in (("k6d", k6d), ("guard", guards), ("k3k4", k3k4), ("sweep", sweep),
                     ("regs", regs)):
        if name in args.only:
            res[name] = fn()
    if args.against:
        res["digests_equal"] = compare(res, json.loads(pathlib.Path(args.against).read_text()))
    cs.log(card)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1, default=str))


if __name__ == "__main__":
    main()
