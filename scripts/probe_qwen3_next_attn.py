"""K11a / K12d at head_dim 256 (Qwen3-Next's attention layers) on the H100.

    python3 scripts/probe_qwen3_next_attn.py [--out probe.json] [--only regs times]

Run from a repository root: the cases go through that tree's wrappers and
``chip_smoke``'s checks (each kernel held to its plain version; the timer
evicts the L2 and spins the device before every launch).

- ``regs``: ``nvcc -Xptxas -v`` of ``csrc/sinks_attention.cu``: registers,
  stack, spills and shared memory of every decode and prefill instance at
  head_dim 256 (and, for comparison, 128), demangled;
- ``times``: K11a ``decode_gqa`` at Qwen3-Next-80B-A3B's 16 / 2 heads x 256
  over the contexts of a decode step of ``chip_smoke``'s [4o] serve (and at
  2048 keys a row), K12d without sinks at a 512-row chunk at context 2048
  and at 512: ms, plain ms, SDPA ms and the bound;
- ``splits``: K11a at those two shapes with its split size forced to 256
  (``decode_split_size``'s choice on a 2048-key table), 128 and 64 keys
  (``decode_attention._split_size``).

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

import chip_smoke as cs  # noqa: E402  (exits without a GPU)
import torch  # noqa: E402

HEADS = (16, 2, 256)


def regs():
    """Each sinks_attention.cu decode / prefill instance at head_dim 128 and
    256: its ``ptxas info`` lines (registers, stack, spills, shared memory)."""
    lib = cs.cuda_lib
    out = {}
    with tempfile.TemporaryDirectory() as work:
        p = subprocess.run([lib._nvcc(), *lib._NVCC_FLAGS, "-Xptxas", "-v", "-I",
                            str(lib._SRC_DIR), "-c", str(lib._SRC_DIR / "sinks_attention.cu"),
                            "-o", str(pathlib.Path(work) / "x.o")],
                           capture_output=True, text=True, check=True)
    name = None
    for line in (p.stderr + p.stdout).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and re.search(r"registers|spill|stack frame", line):
            out.setdefault(name, []).append(line.split("ptxas info    :")[-1].strip())
    filt = pathlib.Path(lib._nvcc()).with_name("cu++filt")
    names = list(out)
    if filt.exists() and names:
        plain = subprocess.run([str(filt), *names], capture_output=True, text=True).stdout
        out = {d: out[n] for n, d in zip(names, plain.splitlines())}
    # demangled names read decode_kernel<256, ...> or decode_kernel<(int)256, ...>
    width = re.compile(r"(?:<|<\(int\)|ILi)(?:256|128)(?:\b|E)")
    out = {k: v for k, v in out.items()
           if ("decode_kernel" in k or "prefill_kernel" in k) and width.search(k)}
    if not out:
        raise RuntimeError("no decode / prefill instance at head_dim 128 or 256 in ptxas's report")
    for k, v in out.items():
        cs.log(f"  {k}: {'; '.join(v)}")
    return out


def times():
    gen = torch.Generator(device=cs.DEV).manual_seed(25)
    dec_ctx = [n + cs.QWEN_NEW_TOKENS for n in cs.QWEN_PROMPT_LENS[:cs.QWEN_BATCH]]
    res = {
        "k11a_step": cs.check_paged_decode(gen, dec_ctx, 0, 0, True, heads=HEADS,
                                           with_sinks=False, table_pages=cs.QWEN_PAGES_PER_REQ),
        "k11a_2048": cs.check_paged_decode(gen, [2048] * 4, 0, 0, True, heads=HEADS,
                                           with_sinks=False, table_pages=cs.QWEN_PAGES_PER_REQ),
        "k12d_512_at_2048": cs.check_paged_prefill(gen, [512], [2048], 0, 0, True, heads=HEADS,
                                                   with_sinks=False,
                                                   table_pages=cs.QWEN_PAGES_PER_REQ),
        "k12d_512_at_512": cs.check_paged_prefill(gen, [512], [512], 0, 0, True, heads=HEADS,
                                                  with_sinks=False,
                                                  table_pages=cs.QWEN_PAGES_PER_REQ),
    }
    return res


def splits():
    """K11a's time by split size at the [4o] decode step's contexts and at
    4 x 2048 keys."""
    da = cs.da
    chosen = da.decode_split_size
    dec_ctx = [n + cs.QWEN_NEW_TOKENS for n in cs.QWEN_PROMPT_LENS[:cs.QWEN_BATCH]]
    res = {}
    try:
        for split in (256, 128, 64):
            da.decode_split_size = lambda t, w, _s=split: da._split_size(t, w, _s)
            gen = torch.Generator(device=cs.DEV).manual_seed(25)
            cs.log(f"  K11a at split {split}")
            for label, ctx in (("step", dec_ctx), ("2048", [2048] * 4)):
                res[f"{label}_split{split}"] = cs.check_paged_decode(
                    gen, ctx, 0, 0, True, heads=HEADS, with_sinks=False,
                    table_pages=cs.QWEN_PAGES_PER_REQ)
    finally:
        da.decode_split_size = chosen
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the numbers here as JSON")
    ap.add_argument("--only", nargs="*", default=["regs", "times"],
                    help="regs, times, splits")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    res = {"card": card}
    if "regs" in args.only:
        res["regs"] = regs()
    if "times" in args.only:
        cs.cuda_lib.load_library()
        res["times"] = times()
    if "splits" in args.only:
        cs.cuda_lib.load_library()
        res["splits"] = splits()
    print(card)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
