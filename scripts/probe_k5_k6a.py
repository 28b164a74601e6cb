#!/usr/bin/env python3
"""Time K5 (``quant_per_token``) and K6a (``rms_norm``) at the main path's
shapes on one NVIDIA GPU, beside their bounds, their plain versions,
``F.rms_norm`` and the launch floor (an empty kernel), with K7a, K1, K8a
int8 and K16b as guards.

    python3 scripts/probe_k5_k6a.py [--out probe.json] [--only k5 k6a guard sweep]

Run from a repository root (or with it on ``sys.path``): the cases go through
that tree's wrappers and ``chip_smoke`` helpers (the timer evicts the L2 and
spins the device before every launch and takes the median), so the same
script times two trees in one call: unpack the parent with ``git archive``
into a git-ignored directory and run change, change, parent, parent.  Random
bf16 inputs from seeds:

- K5 at ``[8, 16384]`` and ``[8, 7168]`` (a fully W8A8 DeepSeek-V3 layer's
  two at decode), ``[64, 7168]`` (the expert-parallel wire quant of a
  64-token chunk) and ``[2048, 7168]``, a zero row in each: held bit-equal to
  its plain version, the digests (SHA-256 of q and the scales) equal across
  trees;
- K6a at ``[512, 2880]`` and ``[8, 2880]`` (GPT-OSS-20B's chunk and decode
  rows) and ``[8, 4096]``, ``[512, 4096]`` (Llama-3.1-8B), a bf16 weight,
  eps 1e-5: within one bf16 ulp of its plain version, timed beside
  ``F.rms_norm``;
- the launch floor: an empty kernel (``csrc/launch_floor.cu``), where the
  tree has it;
- guards: K7a at ``[8, 4096]``, K1 at 8 rows x ``[4096, 7168]`` (times and
  output digests), and ``scripts/probe_k16a_k8b.py``'s K8a int8 (a layer's
  two at 2048 tokens) and K16b (64 tokens);
- ``sweep`` (not run by default; the change's tree only): the launch plans
  around ``ops/row_reduce._row_plan``'s (cluster sizes, threads and vectors a
  thread, rows a block) through the C launchers, and K5 with every level by
  ``__fdiv_rn`` (the tree's ``csrc/quant.cu`` with ``level``'s screened
  branch cut out, built beside the tree's library) at the same plans.

Prints one line a case and the card, and writes the numbers as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path.cwd()))
sys.path.insert(0, str(pathlib.Path.cwd() / "scripts"))

import chip_smoke as cs  # noqa: E402  (exits without a GPU)
import torch  # noqa: E402

K5_SHAPES = ((8, 16384), (8, 7168), (64, 7168), (2048, 7168))
K6A_SHAPES = ((512, 2880), (8, 2880), (8, 4096), (512, 4096))


def k5():
    out = {}
    for rows, h in K5_SHAPES:
        gen = torch.Generator(device=cs.DEV).manual_seed(rows + h)
        x = cs.randn(gen, (rows, h), scale=3.0)
        x[rows // 2] = 0
        q, s = cs.quant.quant_per_token(x)
        q_p, s_p = cs.quant.quant_per_token_ref(x)
        torch.cuda.synchronize()
        r = dict(bit_equal=bool(torch.equal(q, q_p) and torch.equal(s, s_p)),
                 ms=cs.time_ms(lambda: cs.quant.quant_per_token(x), 50),
                 plain_ms=cs.time_ms(lambda: cs.quant.quant_per_token_ref(x), 10),
                 bound_ms=cs.bound(3 * rows * h + 4 * rows, 4 * rows * h, cs.F32_FLOPS)[0],
                 digests=[cs.digest(q), cs.digest(s)])
        cs.log(f"  K5 [{rows}, {h}] bf16: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
               f"{r['bound_ms']:.5f}); bit-equal to plain {r['bit_equal']}; digests "
               f"{r['digests']}")
        out[f"[{rows}, {h}]"] = r
    two = out["[8, 16384]"]["ms"] + out["[8, 7168]"]["ms"]
    out["a layer's two at decode"] = two
    cs.log(f"  K5, a layer's two at decode: {two:.4f} ms")
    return out


def k6a():
    out = {}
    for rows, h in K6A_SHAPES:
        gen = torch.Generator(device=cs.DEV).manual_seed(rows * 7 + h)
        x = cs.randn(gen, (rows, h), scale=3.0)
        w = (1 + 0.1 * torch.randn(h, generator=gen, device=cs.DEV)).to(torch.bfloat16)
        y = cs.norm.rms_norm(x, w, 1e-5)
        err, ok = cs.ulp_close(y, cs.norm.rms_norm_ref(x, w, 1e-5))
        r = dict(err=err, within_ulp=bool(ok),
                 ms=cs.time_ms(lambda: cs.norm.rms_norm(x, w, 1e-5), 50),
                 plain_ms=cs.time_ms(lambda: cs.norm.rms_norm_ref(x, w, 1e-5), 10),
                 library_ms=cs.time_ms(
                     lambda: torch.nn.functional.rms_norm(x, (h,), w, 1e-5), 50),
                 bound_ms=cs.bound(2 * 2 * rows * h + 2 * h, 4 * rows * h, cs.F32_FLOPS)[0],
                 digest=cs.digest(y))
        cs.log(f"  K6a [{rows}, {h}] bf16: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
               f"F.rms_norm {r['library_ms']:.4f}, bound {r['bound_ms']:.5f}); max|err| "
               f"{err:.3e} within a bf16 ulp {ok}; digest {r['digest']}")
        out[f"[{rows}, {h}]"] = r
    return out


def launch_floor():
    lib = cs.cuda_lib.load_library()
    if "empty_launch" not in cs.cuda_lib._SIGNATURES:
        cs.log("  launch floor: this tree has no empty kernel")
        return None
    stream = torch.cuda.current_stream().cuda_stream
    ms = cs.time_ms(lambda: cs.cuda_lib.check(lib, lib.empty_launch(stream), "empty"),
                    50)
    cs.log(f"  launch floor (an empty kernel): {ms:.4f} ms")
    return ms


def guards():
    import probe_k16a_k8b

    out = {}
    gen = torch.Generator(device=cs.DEV).manual_seed(4096)
    x = cs.randn(gen, (8, 4096), scale=2.0)
    call = lambda: cs.activation.swiglu_quant(x, None, group_list_type=1)  # noqa: E731
    q, s = call()
    out["K7a [8, 4096]"] = dict(ms=cs.time_ms(call, 50), digests=[cs.digest(q), cs.digest(s)])
    xq = torch.randint(-128, 128, (8, 7168), generator=gen, device=cs.DEV, dtype=torch.int8)
    w = torch.randint(-128, 128, (4096, 7168), generator=gen, device=cs.DEV, dtype=torch.int8)
    ds = torch.rand(4096, generator=gen, device=cs.DEV) / 1000
    call = lambda: cs.matmul.quant_matmul(xq, w, ds, None, out_dtype=torch.bfloat16)  # noqa: E731
    out["K1 8 x [4096, 7168]"] = dict(ms=cs.time_ms(call, 50), digest=cs.digest(call()))
    for k in ("K7a [8, 4096]", "K1 8 x [4096, 7168]"):
        cs.log(f"  {k}: {out[k]['ms']:.4f} ms; {out[k]}")
    cs.ep_group()
    moe0 = cs.m.init_quantized_experts(dataclasses.replace(cs.CFG, num_layers=1),
                                       cs.SEED + 1)[0]
    out.update(probe_k16a_k8b.guards(moe0))
    cs.dist.destroy_process_group()
    return out


def _divide_every_level():
    """``quant_per_token_launch`` of the tree's ``csrc/quant.cu`` with the
    screened branch of ``level`` cut out: every level by ``__fdiv_rn``."""
    import ctypes
    import tempfile

    lib = cs.cuda_lib
    src = (lib._SRC_DIR / "quant.cu").read_text()
    start = src.index("  if (fabsf(__fadd_rn(q, -__fadd_rn(t, -MAGIC)))")
    end = src.index("  return saturate(__fdiv_rn(v, s));")
    lib._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(dir=lib._BUILD_DIR))
    (work / "quant.cu").write_text(src[:start] + src[end:])
    nvcc, flags = lib._nvcc(), [*lib._NVCC_FLAGS, "-I", str(lib._SRC_DIR)]
    for f in (work / "quant.cu", lib._SRC_DIR / "errors.cu"):
        subprocess.run([nvcc, *flags, "-c", str(f), "-o", str(work / (f.stem + ".o"))],
                       check=True)
    subprocess.run([nvcc, *flags, "-shared", "-cudart", "shared", str(work / "quant.o"),
                    str(work / "errors.o"), "-o", str(work / "libdivide.so")], check=True)
    so = ctypes.CDLL(str(work / "libdivide.so"))
    so.quant_per_token_launch.argtypes = lib._SIGNATURES["quant_per_token_launch"]
    return so


def _plans(rows, h, clusters, block_rows, **plan_kw):
    """The default plan (``_row_plan(..., **plan_kw)``) and its neighbours:
    each cluster size, one, two or four bf16 vectors a thread (at most 512
    threads), each rows-a-block."""
    from sgl_kernel_npu_tpu_torch.ops import row_reduce as rr

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {rr._row_plan(rows, h, 2, sms, **plan_kw)}
    for c in clusters:
        per = -(-(h // 8) // c)
        for tv in (1, 2, 4):
            t = min(512, max(32, -(-(-(-per // tv)) // 32) * 32))
            for br in (block_rows if c == 1 else (1,)):
                out.add(rr.RowPlan(c, t, -(-per // t), 8, br))
    return sorted(out)


def sweep():
    lib = cs.cuda_lib.load_library()
    divide = _divide_every_level()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}

    def timed(label, plans, launch):
        res = {}
        for _ in range(2):
            for name, plan in plans:
                ms = cs.time_ms(lambda: launch(name, plan), 40)
                res.setdefault((name, tuple(plan)), []).append(ms)
        best = sorted((min(v), k, v) for k, v in res.items())
        cs.log(f"  {label}:")
        for ms, (name, plan), v in best:
            cs.log(f"    {ms:.4f} {name} {plan} (runs {', '.join(f'{t:.4f}' for t in v)})")
        out[label] = [dict(ms=v, variant=name, plan=plan) for _, (name, plan), v in best]

    for rows, h, clusters, brs in ((8, 16384, (1, 2, 4, 8), (1,)), (8, 7168, (1, 2, 4, 8), (1,)),
                                   (64, 7168, (1, 2, 4), (1,)), (512, 7168, (1,), (1, 2, 4)),
                                   (2048, 7168, (1,), (1, 2, 4, 8))):
        x = cs.randn(torch.Generator(device=cs.DEV).manual_seed(rows + h), (rows, h), scale=3.0)
        q = torch.empty((rows, h), dtype=torch.int8, device=cs.DEV)
        s = torch.empty(rows, device=cs.DEV)

        def k5(name, plan):
            so = lib if name == "screened" else divide
            cs.cuda_lib.check(lib, so.quant_per_token_launch(
                x.data_ptr(), rows, h, 1, *plan, q.data_ptr(), s.data_ptr(), stream), name)
        plans = [(n, p) for p in _plans(rows, h, clusters, brs) for n in ("screened", "divide")]
        timed(f"K5 [{rows}, {h}]", plans, k5)
    for rows, h, clusters, brs in ((8, 2880, (1, 2), (1,)), (8, 4096, (1, 2), (1,)),
                                   (512, 2880, (1,), (1, 2, 4)), (512, 4096, (1,), (1, 2, 4))):
        x = cs.randn(torch.Generator(device=cs.DEV).manual_seed(rows + h), (rows, h), scale=3.0)
        w = torch.ones(h, dtype=torch.bfloat16, device=cs.DEV)
        y = torch.empty_like(x)

        def k6a(name, plan):
            cs.cuda_lib.check(lib, lib.rms_norm_launch(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, h, 1, 1, 1e-5, *plan, stream),
                name)
        timed(f"K6a [{rows}, {h}]", [("kernel", p) for p in _plans(rows, h, clusters, brs)], k6a)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the numbers here as JSON")
    ap.add_argument("--only", nargs="+", choices=("k5", "k6a", "guard", "sweep"),
                    default=("k5", "k6a", "guard"),
                    help="these cases alone (with the launch floor)")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(card)
    cs.log(f"tree: {pathlib.Path(cs.__file__).resolve().parent}, package "
           f"{pathlib.Path(cs.cuda_lib.__file__).resolve().parents[1]}")
    cs.cuda_lib.load_library()
    res = {"card": card, "launch_floor_ms": launch_floor()}
    if "k5" in args.only:
        res["k5"] = k5()
    if "k6a" in args.only:
        res["k6a"] = k6a()
    if "guard" in args.only:
        res["guard"] = guards()
    if "sweep" in args.only:
        res["sweep"] = sweep()
    cs.log(card)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1, default=str))


if __name__ == "__main__":
    main()
