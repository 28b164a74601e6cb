"""Shared by the port's parity tests (tests/test_torch_*.py): one numpy input
goes to the JAX package (Pallas kernels in interpret mode on the CPU) and to
the port's plain PyTorch path, and the outputs come back as numpy."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

# the suite runs several pytest workers on a few cores: keep each one small
torch.set_num_threads(2)


def jx(a, dtype=None):
    """numpy → jax array (optionally cast, e.g. to bf16)."""
    arr = jnp.asarray(a)
    return arr if dtype is None else arr.astype(dtype)


def tt(a, dtype=None):
    """numpy → CPU torch tensor (optionally cast; bf16 rounds like jnp)."""
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def np32(x):
    """jax array or torch tensor → float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def port_config(jax_cfg, port_cls):
    """The port's config with the JAX config's values for the fields it has
    (all but the rope base, which the port leaves out: no path reads it)."""
    return port_cls(**{f.name: getattr(jax_cfg, f.name)
                       for f in dataclasses.fields(port_cls)})


def one_rank_group():
    """The default ``torch.distributed`` group of this test process, made on
    first use: one gloo rank over an in-process store (no port, no file)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    return dist.group.WORLD


def one_rank_mesh():
    """A one-rank ``DeviceMesh`` with the JAX training mesh's axes ``("dp",
    "ep")`` on :func:`one_rank_group`."""
    from torch.distributed.device_mesh import init_device_mesh

    one_rank_group()
    return init_device_mesh("cpu", (1, 1), mesh_dim_names=("dp", "ep"))


class TwoRankMesh:
    """Stands for a ``("dp", "ep")`` DeviceMesh of two ranks, which one
    process cannot make (``test_torch_ep_two_ranks.py`` makes a real one)."""

    mesh_dim_names = ("dp", "ep")

    def size(self):
        return 2
