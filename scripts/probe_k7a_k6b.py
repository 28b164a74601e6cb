#!/usr/bin/env python3
"""Time K7a (``swiglu_quant``) and K6b / K6c (``add_rms_norm_bias``,
``add_gemma_rms_norm``) at the main path's shapes on one NVIDIA GPU, beside
their bounds, their plain versions and the launch floor (an empty kernel),
with K5, K6a and K6d as guards.

    python3 scripts/probe_k7a_k6b.py [--out probe.json] [--only k7a k6b guard sweep regs]
                                     [--against other.json]

Run from a repository root (or with it on ``sys.path``): the cases go through
that tree's wrappers and ``chip_smoke`` helpers (the timer evicts the L2 and
spins the device before every launch and takes the median of 50), so the
same script times two trees in one call: unpack the parent with ``git
archive`` into a git-ignored directory and run change, change, parent,
parent.  ``--against`` another run's JSON prints whether each case's
SHA-256 digests equal that run's.  Random bf16 inputs from seeds:

- K7a at ``[8, 4096]`` and ``[2048, 4096]`` (DeepSeek-V3's shared expert,
  gate ‖ up, at decode and a long chunk) and ``[8, 28672]``, ``[512,
  28672]`` (Llama-3.1-8B's MLP at decode and a 512-row chunk), a zero row in
  each; with a group list at ``[8, 4096]`` (5 live rows) and ``[8, 28672]``
  (3: clusters whose row is dead): within one level of the plain version,
  digests of the levels and the scales;
- K6b without and with its static int8 quant and K6c at ``[512, 4096]`` and
  ``[8, 4096]`` (Llama's width), K6b also at ``[512, 7168]`` (DeepSeek's), a
  bf16 weight and bias, eps 1e-5: bit-equal to ``add_rms_norm_rows_plain``
  where the tree has it, else within one bf16 ulp (one level) of the plain
  version; digests of the output and the residual sum;
- the launch floor: an empty kernel (``csrc/launch_floor.cu``);
- guards: K5 at ``[8, 16384]`` and ``[2048, 7168]``, K6a at ``[512, 2880]``,
  K6d at ``[512, 4096]`` (times and digests; their code is unchanged);
- ``sweep`` (not run by default; the change's tree only): K7a's launch plans
  around ``ops/row_reduce._row_plan(..., inputs=2)``'s (cluster sizes,
  threads and vectors a thread, rows a block) through the C launcher, and
  K6b's likewise, its quantized mode both with the quant scale and offset
  held in registers where a block takes several rows and read a row always
  (the tree's ``csrc/norm.cu`` with ``HOLD_QUANT`` flipped, built beside the
  tree's library);
- ``regs`` (not run by default): ``nvcc -Xptxas -v`` of ``csrc/quant.cu``
  and ``csrc/norm.cu``: registers, stack and spills of every K7a and K6b /
  K6c instance.

Prints one line a case and the card, and writes the numbers as JSON.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path.cwd()))
sys.path.insert(1, str(pathlib.Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402  (exits without a GPU)
import torch  # noqa: E402
from probe_k5_k6a import _plans  # noqa: E402

K7A_CASES = ((8, 4096, None), (8, 28672, None), (512, 28672, None), (2048, 4096, None),
             (8, 4096, 5), (8, 28672, 3))                 # (rows, gate ‖ up width, live rows)
K6_CASES = (("bias", 512, 4096), ("quant", 512, 4096), ("gemma", 512, 4096),
            ("bias", 8, 4096), ("quant", 8, 4096), ("gemma", 8, 4096),
            ("bias", 512, 7168), ("quant", 512, 7168))


def k7a():
    out = {}
    for rows, width, total in K7A_CASES:
        gen = torch.Generator(device=cs.DEV).manual_seed(rows + width)
        x = cs.randn(gen, (rows, width), scale=2.0)
        x[0] = 0
        gl = None if total is None else torch.tensor([total], dtype=torch.int32, device=cs.DEV)
        call = lambda: cs.activation.swiglu_quant(x, gl, group_list_type=1)  # noqa: E731
        ref = lambda: cs.activation.swiglu_quant_ref(x, gl, group_list_type=1)  # noqa: E731
        (q, s), (q_p, s_p) = call(), ref()
        torch.cuda.synchronize()
        live = rows if total is None else total
        err = cs.max_abs(q, q_p)
        r = dict(err=err, within_level=err <= 1, ms=cs.time_ms(call, 50),
                 plain_ms=cs.time_ms(ref, 10),
                 bound_ms=cs.bound(2 * live * width + rows * width // 2 + 4 * rows,
                                   4 * live * width, cs.F32_FLOPS)[0],
                 digests=[cs.digest(q), cs.digest(s)])
        key = f"[{rows}, {width}]" + ("" if total is None else f" {total} live")
        cs.log(f"  K7a {key} bf16: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
               f"{r['bound_ms']:.5f}); max|q err| {err:.0f} level; digests {r['digests']}")
        out[key] = r
    return out


def _k6_inputs(mode, rows, h):
    gen = torch.Generator(device=cs.DEV).manual_seed(rows * 13 + h)
    x = cs.randn(gen, (rows, h), scale=2.0)
    res = cs.randn(gen, (rows, h))
    w = (1 + 0.1 * torch.randn(h, generator=gen, device=cs.DEV)).to(torch.bfloat16)
    b = cs.randn(gen, (h,), scale=0.1)
    qs = 20 + 20 * torch.rand(h, generator=gen, device=cs.DEV)
    qo = 4 * torch.rand(h, generator=gen, device=cs.DEV) - 2
    return x, res, w, b, qs, qo


def _k6_calls(mode, x, res, w, b, qs, qo):
    """(kernel call, plain call) of K6b / K6c in ``mode``."""
    n = cs.norm
    if mode == "gemma":
        return (lambda: n.add_gemma_rms_norm(x, w, res, 1e-5),
                lambda: n.add_gemma_rms_norm_ref(x, w, res, 1e-5))
    q = {"quant_scale": qs, "quant_offset": qo} if mode == "quant" else {}
    return (lambda: n.add_rms_norm_bias(x, res, w, b, 1e-5, **q),
            lambda: n.add_rms_norm_bias_ref(x, res, w, b, 1e-5, **q))


def k6b():
    out = {}
    for mode, rows, h in K6_CASES:
        x, res, w, b, qs, qo = _k6_inputs(mode, rows, h)
        fn, ref = _k6_calls(mode, x, res, w, b, qs, qo)
        (got, added), (want, want_added) = fn(), ref()
        torch.cuda.synchronize()
        if mode == "quant":
            diff = (got.int() - want.int()).abs()
            err = float(diff.max())
            ok = err <= 1 and float((diff == 0).float().mean()) >= 0.99
        else:
            err, ok = cs.ulp_close(got, want)
        mirror = None
        if hasattr(cs.norm, "add_rms_norm_rows_plain"):
            q = (qs.cpu(), qo.cpu()) if mode == "quant" else (None, None)
            m, ma = cs.norm.add_rms_norm_rows_plain(
                x.cpu(), res.cpu(), w.cpu(), None if mode == "gemma" else b.cpu(), *q, mode,
                1e-5, cs.row_reduce.launch_plan(x, res, w, inputs=2))
            mirror = bool(torch.equal(got.cpu(), m) and torch.equal(added.cpu(), ma))
        vec_bytes = 2 * h * (2 if mode != "gemma" else 1) + (8 * h if mode == "quant" else 0)
        r = dict(err=err, close_to_plain=bool(ok and torch.equal(added, want_added)),
                 bit_equal_to_mirror=mirror, ms=cs.time_ms(fn, 50), plain_ms=cs.time_ms(ref, 10),
                 bound_ms=cs.bound(rows * h * (3 * 2 + (1 if mode == "quant" else 2)) + vec_bytes,
                                   8 * rows * h, cs.F32_FLOPS)[0],
                 digests=[cs.digest(got), cs.digest(added)])
        name = "K6c" if mode == "gemma" else "K6b"
        key = f"{name} {mode} [{rows}, {h}]"
        cs.log(f"  {key} bf16: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
               f"{r['bound_ms']:.5f}); err {err:.3e}, close to plain {r['close_to_plain']}, "
               f"bit-equal to the mirror {mirror}; digests {r['digests']}")
        out[key] = r
    return out


def launch_floor():
    lib = cs.cuda_lib.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    ms = cs.time_ms(lambda: cs.cuda_lib.check(lib, lib.empty_launch(stream), "empty"), 50)
    cs.log(f"  launch floor (an empty kernel): {ms:.4f} ms")
    return ms


def guards():
    out = {}
    for rows, h in ((8, 16384), (2048, 7168)):
        gen = torch.Generator(device=cs.DEV).manual_seed(rows + h)
        x = cs.randn(gen, (rows, h), scale=3.0)
        x[rows // 2] = 0
        q, s = cs.quant.quant_per_token(x)
        out[f"K5 [{rows}, {h}]"] = dict(ms=cs.time_ms(lambda: cs.quant.quant_per_token(x), 50),
                                        digests=[cs.digest(q), cs.digest(s)])
    gen = torch.Generator(device=cs.DEV).manual_seed(512 * 7 + 2880)
    x = cs.randn(gen, (512, 2880), scale=3.0)
    w = (1 + 0.1 * torch.randn(2880, generator=gen, device=cs.DEV)).to(torch.bfloat16)
    out["K6a [512, 2880]"] = dict(ms=cs.time_ms(lambda: cs.norm.rms_norm(x, w, 1e-5), 50),
                                  digests=[cs.digest(cs.norm.rms_norm(x, w, 1e-5))])
    gen = torch.Generator(device=cs.DEV).manual_seed(512 + 4096)
    x = (torch.randn((512, 4096), generator=gen, device=cs.DEV) + 0.5).to(torch.bfloat16)
    out["K6d [512, 4096]"] = dict(ms=cs.time_ms(lambda: cs.norm.l1_norm(x), 50),
                                  digests=[cs.digest(cs.norm.l1_norm(x))])
    for k, v in out.items():
        cs.log(f"  guard {k}: {v['ms']:.4f} ms; digests {v['digests']}")
    return out


def _variant(source: str, old: str, new: str):
    """The tree's library rebuilt with ``old`` replaced by ``new`` in
    ``csrc/<source>`` (that source and ``errors.cu`` only), loaded with the
    tree's signatures."""
    import ctypes

    lib = cs.cuda_lib
    src = (lib._SRC_DIR / source).read_text()
    assert old in src, old
    lib._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(dir=lib._BUILD_DIR))
    (work / source).write_text(src.replace(old, new))
    nvcc, flags = lib._nvcc(), [*lib._NVCC_FLAGS, "-I", str(lib._SRC_DIR)]
    objs = []
    for f in (work / source, lib._SRC_DIR / "errors.cu"):
        objs.append(str(work / (f.stem + ".o")))
        subprocess.run([nvcc, *flags, "-c", str(f), "-o", objs[-1]], check=True)
    subprocess.run([nvcc, *flags, "-shared", "-cudart", "shared", *objs, "-o",
                    str(work / "libvariant.so")], check=True)
    so = ctypes.CDLL(str(work / "libvariant.so"))
    for name, args in lib._SIGNATURES.items():
        if hasattr(so, name):
            getattr(so, name).argtypes = args
    return so


def _timed(out, label, plans, launch):
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


def sweep():
    lib = cs.cuda_lib.load_library()
    read = _variant("norm.cu", "constexpr bool HOLD_QUANT = true;",
                    "constexpr bool HOLD_QUANT = false;")
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for rows, width, clusters, brs in ((8, 4096, (1, 2), (1,)), (8, 28672, (2, 4, 8), (1,)),
                                       (512, 28672, (1,), (1, 2, 4)),
                                       (2048, 4096, (1,), (1, 2, 4, 8))):
        x = cs.randn(torch.Generator(device=cs.DEV).manual_seed(rows + width), (rows, width),
                     scale=2.0)
        q = torch.empty((rows, width // 2), dtype=torch.int8, device=cs.DEV)
        s = torch.empty(rows, device=cs.DEV)

        def k7a(name, plan):
            cs.cuda_lib.check(lib, lib.swiglu_quant_launch(
                x.data_ptr(), rows, width // 2, 1, None, 1, *plan, q.data_ptr(), s.data_ptr(),
                stream), name)
        plans = [("kernel", p) for p in _plans(rows, width // 2, clusters, brs, inputs=2)]
        _timed(out, f"K7a [{rows}, {width}]", plans, k7a)
    for mode, rows, h, clusters, brs in (("quant", 512, 4096, (1,), (1, 2, 4)),
                                         ("quant", 8, 4096, (1, 2), (1,)),
                                         ("quant", 512, 7168, (1,), (1, 2, 4)),
                                         ("bias", 512, 4096, (1,), (1, 2, 4)),
                                         ("bias", 8, 4096, (1, 2), (1,))):
        x, res, w, b, qs, qo = _k6_inputs(mode, rows, h)
        y = torch.empty(x.shape, dtype=torch.int8 if mode == "quant" else x.dtype,
                        device=cs.DEV)
        added = torch.empty_like(x)
        m = {"bias": 0, "quant": 1}[mode]

        def k6b(name, plan):
            so = read if name == "read a row" else lib
            cs.cuda_lib.check(lib, so.add_rms_norm_launch(
                x.data_ptr(), res.data_ptr(), w.data_ptr(), b.data_ptr(), qs.data_ptr(),
                qo.data_ptr(), y.data_ptr(), added.data_ptr(), rows, h, 1, 1, 1, m, 1e-5,
                *plan, stream), name)
        names = ("held", "read a row") if mode == "quant" else ("kernel",)
        plans = [(n, p) for p in _plans(rows, h, clusters, brs, inputs=2) for n in names]
        _timed(out, f"K6b {mode} [{rows}, {h}]", plans, k6b)
    return out


def regs():
    """``nvcc -Xptxas -v`` of quant.cu and norm.cu: each K7a and K6b / K6c
    instance's registers, stack and spill lines, demangled."""
    lib = cs.cuda_lib
    out = {}
    with tempfile.TemporaryDirectory() as work:
        for src in ("quant.cu", "norm.cu"):
            p = subprocess.run([lib._nvcc(), *lib._NVCC_FLAGS, "-Xptxas", "-v", "-I",
                                str(lib._SRC_DIR), "-c", str(lib._SRC_DIR / src), "-o",
                                str(pathlib.Path(work) / "x.o")],
                               capture_output=True, text=True, check=True)
            text = p.stderr + p.stdout
            name = None
            for line in text.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    name = m.group(1)
                elif name and ("swiglu_quant_kernel" in name or "add_rms_norm_kernel" in name) \
                        and re.search(r"registers|spill|stack frame", line):
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
    for group in ("k7a", "k6b", "guard"):
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
    ap.add_argument("--only", nargs="+", choices=("k7a", "k6b", "guard", "sweep", "regs"),
                    default=("k7a", "k6b", "guard"),
                    help="these cases alone (with the launch floor)")
    ap.add_argument("--against", default=None, help="another run's JSON: compare the digests")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(card)
    cs.log(f"tree: {pathlib.Path(cs.__file__).resolve().parent}")
    cs.cuda_lib.load_library()
    res = {"card": card, "launch_floor_ms": launch_floor()}
    for name, fn in (("k7a", k7a), ("k6b", k6b), ("guard", guards), ("sweep", sweep),
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
