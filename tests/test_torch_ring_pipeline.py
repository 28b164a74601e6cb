"""Port parity: ``parallel/ring_attention`` and ``parallel/pipeline`` on
gloo ranks against the JAX package's on the virtual CPU mesh.

One spawn of four rank processes (``tests/_torch_mr_ranks.py``, task
``"ring"``) runs every case on groups of 4, 2 and 1 ranks (the halves and
the ranks' own groups made with ``dist.new_group``); JAX's goldens are made
once a module while the ranks run.  Ring attention: MHA and GQA, causal and
not, f32 and bf16, each through ``ring_attention_sharded`` on 1, 2 and 4
ranks against JAX's ``ring_attention_sharded`` on the same ring and
``ring_attention_ref`` (f32 within 2e-5, JAX's own tolerance; bf16 within
2e-2 of the largest value: the output is rounded to bf16 after f32 sums in
another order), and JAX's first-token isolation case (token 0 attends only
to itself across the ranks, within 1e-5).  Every rank's output has the same
bits.  ``pipeline_forward`` on 2 and 4 stages with 1, 2 and 4 microbatches:
the output and every stage's gradient of ``sum(y²)`` against JAX's
``jax.grad`` through its ``pipeline_forward`` and against the sequential
model (f32 within 1e-5 of the largest value)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_mr_ranks import start_ranks
from _torch_parity import np32
from sgl_kernel_npu_tpu.parallel.pipeline import pipeline_forward
from sgl_kernel_npu_tpu.parallel.ring_attention import ring_attention_ref, ring_attention_sharded
from sgl_kernel_npu_tpu_torch.parallel import ring_attention as tra

WORLD = 4
SIZES = (1, 2, 4)
B, TL, D = 2, 4, 16
T = WORLD * TL
RING = {f"{hq}x{hkv}-{'causal' if causal else 'full'}-{dt}": (hq, hkv, causal, dt)
        for hq, hkv in ((4, 4), (4, 2)) for causal in (True, False) for dt in ("f32", "bf16")}
PIPE = {f"{stages}st-{micro}mb": (stages, micro) for stages in (2, 4) for micro in (1, 2, 4)}
PD, PH, PB = 8, 16, 8


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("cp",))


def _ring_inputs(rng):
    cases = {}
    for name, (hq, hkv, causal, dt) in RING.items():
        q, k, v = (rng.standard_normal((B, T, h, D)).astype(np.float32) * 0.5
                   for h in (hq, hkv, hkv))
        cases[name] = dict(q=q, k=k, v=v, dtype=dt, causal=causal, scale=1.0 / np.sqrt(D))
    iso = [rng.standard_normal((1, T, 4, D)).astype(np.float32) for _ in range(3)]
    cases["isolation"] = dict(q=iso[0], k=iso[1], v=iso[2], dtype="f32", causal=True, scale=0.2)
    return cases


def _pipe_inputs(rng):
    return {name: dict(stages=st, num_micro=mb,
                       w1=(rng.standard_normal((st, PD, PH)) * 0.3).astype(np.float32),
                       b1=(rng.standard_normal((st, PH)) * 0.1).astype(np.float32),
                       w2=(rng.standard_normal((st, PH, PD)) * 0.3).astype(np.float32),
                       x=rng.standard_normal((PB, PD)).astype(np.float32))
            for name, (st, mb) in PIPE.items()}


def _jstage(sp, x):
    return jnp.tanh(x @ sp["w1"] + sp["b1"]) @ sp["w2"]


def _jax_pipe(case):
    params = {n: jnp.asarray(case[n]) for n in ("w1", "b1", "w2")}
    mesh = Mesh(np.array(jax.devices()[:case["stages"]]), ("pp",))

    def loss(p, x):
        y = pipeline_forward(_jstage, p, x, mesh=mesh, axis_name="pp",
                             num_micro=case["num_micro"])
        return jnp.sum(y * y), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, jnp.asarray(case["x"]))
    return {"y": np32(y), **{n: np32(a) for n, a in g.items()}}


def _sequential(case):
    """The stages applied in turn on the whole batch, its gradients by torch autograd."""
    params = {n: torch.from_numpy(case[n]).requires_grad_() for n in ("w1", "b1", "w2")}
    y = torch.from_numpy(case["x"])
    for s in range(case["stages"]):
        y = torch.tanh(y @ params["w1"][s] + params["b1"][s]) @ params["w2"][s]
    (y * y).sum().backward()
    return {"y": np32(y), **{n: np32(p.grad) for n, p in params.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(28)
    ring, pipe = _ring_inputs(rng), _pipe_inputs(rng)
    wait = start_ranks(tmp_path_factory.mktemp("ring"),
                       {"task": "ring", "world": WORLD, "sizes": SIZES, "ring": ring,
                        "pipe": pipe})
    want = {}
    for name, case in ring.items():
        jdt = jnp.bfloat16 if case["dtype"] == "bf16" else jnp.float32
        q, k, v = (jnp.asarray(case[n], jdt) for n in ("q", "k", "v"))
        want[name] = {"ref": np32(ring_attention_ref(q, k, v, case["scale"],
                                                     causal=case["causal"]))}
        for size in SIZES:
            want[name][size] = np32(ring_attention_sharded(
                q, k, v, mesh=_mesh(size), axis_name="cp", sm_scale=case["scale"],
                causal=case["causal"]))
    pipe_want = {name: _jax_pipe(case) for name, case in pipe.items()}
    return ring, pipe, want, pipe_want, wait()


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", list(RING))
def test_ring_attention_matches_jax(runs, name, size):
    _, _, want, _, outs = runs
    got = outs[0]["ring"][name, size]
    for out in outs[1:]:
        np.testing.assert_array_equal(out["ring"][name, size], got)
    if name.endswith("f32"):
        np.testing.assert_allclose(got, want[name][size], rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, want[name]["ref"], rtol=2e-5, atol=2e-5)
    else:
        _close(got, want[name][size], 2e-2)
        _close(got, want[name]["ref"], 2e-2)


@pytest.mark.parametrize("size", SIZES)
def test_ring_first_token_isolation(runs, size):
    ring, _, want, _, outs = runs
    got = outs[0]["ring"]["isolation", size]
    np.testing.assert_allclose(got[0, 0], ring["isolation"]["v"][0, 0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want["isolation"][size], rtol=2e-5, atol=2e-5)


def test_ring_attention_ref_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 12, h, 8)).astype(np.float32) for h in (6, 3, 3))
    for causal in (True, False):
        want = np32(ring_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3,
                                       causal=causal))
        got = np32(tra.ring_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), 0.3, causal=causal))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ring", [2, 4])
@pytest.mark.parametrize("heads", [(4, 4), (6, 2)])
def test_gathered_attention_matches_jax_ref_rows(ring, heads):
    """``gathered_attention`` (the CP prefill's attention: one rank's rows
    against K / V every rank holds) at each rank's offset against JAX's
    ``ring_attention_ref`` rows there (f32 within 2e-5, as above)."""
    rng = np.random.default_rng(11)
    hq, hkv = heads
    q, k, v = (rng.standard_normal((2, 12, h, 8)).astype(np.float32) for h in (hq, hkv, hkv))
    want = np32(ring_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3))
    tl = 12 // ring
    for me in range(ring):
        rows = slice(me * tl, (me + 1) * tl)
        got = np32(tra.gathered_attention(torch.from_numpy(q[:, rows]), torch.from_numpy(k),
                                          torch.from_numpy(v), 0.3, q_offset=me * tl))
        np.testing.assert_allclose(got, want[:, rows], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", list(PIPE))
def test_pipeline_forward_and_gradients_match_jax(runs, name):
    _, pipe, _, pipe_want, outs = runs
    case = pipe[name]
    stages = case["stages"]
    seq = _sequential(case)
    members = range(stages)                  # the group of ranks 0 .. stages-1
    for r in members:
        np.testing.assert_array_equal(outs[r]["pipe"][name]["y"], outs[0]["pipe"][name]["y"])
    got = {"y": outs[0]["pipe"][name]["y"]}
    for n in ("w1", "b1", "w2"):
        # rank s holds stage s's gradient; the other stages' slices are zero there
        got[n] = np.stack([outs[s]["pipe"][name][n][s] for s in members])
        for s in members:
            rest = np.delete(outs[s]["pipe"][name][n], s, axis=0)
            assert not rest.any(), (n, s)
    for key, g in got.items():
        _close(g, pipe_want[name][key], 1e-5)
        _close(g, seq[key], 1e-5)


def test_pipeline_refusals():
    from sgl_kernel_npu_tpu_torch.parallel.pipeline import pipeline_forward_rank

    x = torch.zeros((6, 4))
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_forward_rank(lambda p, h: h, None, x, group=None, num_micro=4)
    with pytest.raises(ValueError, match="shape and dtype"):
        pipeline_forward_rank(lambda p, h: h[:, :2], None, x, group=None, num_micro=2)
