"""The port's error-feedback int8 sum (``optim.compression.ef_psum`` and
``ef_psum_tree``) against the reference's, bit for bit.

The reference's collective runs under ``jax.vmap`` with a named axis: the
vmapped axis stands for the ranks, and ``pmax``/``psum`` over it are the
collectives (one CPU device). The port's runs in 2 or 4 spawned gloo
processes (a ``FileStore`` in a temporary directory, no network), each rank
with its own row of the same numpy draws, the axis named by a dim of the
ambient mesh or given as the process group. Three rounds carry the error
state from zero; every round's sum and every rank's new error must equal
the reference's in every bit, for fp32 and bf16 gradients, and for a tree
with an all-zero leaf and a leaf of exact halves (round half to even).
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as ref_C
from repro_torch.optim import compression as C

ROUNDS = 3
CASES = ("f32", "bf16", "tree")
ROUTES = ("name", "group")


def _draws(world: int, case: str, rnd: int):
    """Round `rnd`'s gradients of every rank, stacked on a leading axis of
    `world`: {leaf name: fp32 numpy array}; bf16 cases are rounded to bf16
    (and held as the fp32 of those bits)."""
    rng = np.random.default_rng(1000 * world + 10 * CASES.index(case) + rnd)
    # each rank at its own magnitude, so the shared scale is another rank's
    scale = np.float32(10.0) ** rng.integers(-3, 2, (world, 1, 1))
    out = {"g": (rng.standard_normal((world, 8, 16)) * scale)
           .astype(np.float32)}
    if case == "tree":
        out["zero"] = np.zeros((world, 5), np.float32)
        ties = np.zeros((world, 6), np.float32)
        ties[0] = [127.0, 63.5, -0.5, 0.5, 1.5, 2.5]     # scale 1 exactly
        ties[1:] = [1.0, 0.5, 2.5, -1.5, 0.0, 3.5]
        out["w"] = {"ties": ties if rnd == 0 else ties * 0}
    if case == "bf16":
        out["g"] = np.asarray(jnp.asarray(out["g"]).astype(jnp.bfloat16)
                              .astype(jnp.float32))
    return out


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _reference(world: int, case: str):
    """[(sums, new errors) per round], each a tree of (world, ...) arrays."""
    def one(g, e):
        return ref_C.ef_psum_tree(g, e, "d")

    run = jax.vmap(one, axis_name="d")
    errs, out = None, []
    for rnd in range(ROUNDS):
        g = _tree_map(jnp.asarray, _draws(world, case, rnd))
        if case == "bf16":
            g = _tree_map(lambda x: x.astype(jnp.bfloat16), g)
        if errs is None:
            errs = _tree_map(lambda x: jnp.zeros(x.shape, jnp.float32), g)
        if case == "tree":
            s, errs = run(g, errs)
        else:
            s, e = jax.vmap(lambda a, b: ref_C.ef_psum(a, b, "d"),
                            axis_name="d")(g["g"], errs["g"])
            s, errs = {"g": s}, {"g": e}
        out.append((_tree_map(np.asarray, s), _tree_map(np.asarray, errs)))
    return out


def _rank_main(rank, world, store, outdir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime.sharding import set_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_debug_mesh(world, 1, device_type="cpu")
        res = {}
        for case in CASES:
            for route in ROUTES:
                axis = "data" if route == "name" else dist.group.WORLD
                errs, rounds = None, []
                for rnd in range(ROUNDS):
                    g = _tree_map(lambda x: torch.from_numpy(x[rank].copy()),
                                  _draws(world, case, rnd))
                    if case == "bf16":
                        g = _tree_map(lambda x: x.to(torch.bfloat16), g)
                    if errs is None:
                        errs = _tree_map(lambda x: torch.zeros(
                            x.shape, dtype=torch.float32), g)
                    with set_mesh(mesh):
                        if case == "tree":
                            s, errs = C.ef_psum_tree(g, errs, axis)
                        else:
                            s, e = C.ef_psum(g["g"], errs["g"], axis)
                            s, errs = {"g": s}, {"g": e}
                    rounds.append((s, errs))
                res[(case, route)] = rounds
        torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, tmp_path_factory):
    import torch.multiprocessing as mp

    world = request.param
    d = tmp_path_factory.mktemp(f"ef_psum{world}")
    mp.spawn(_rank_main, nprocs=world, join=True,
             args=(world, str(d / "store"), str(d)))
    return world, [torch.load(d / f"rank{r}.pt") for r in range(world)]


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", CASES)
def test_ef_psum_equals_reference_bitwise(ranks, case, route):
    world, per_rank = ranks
    want = _reference(world, case)
    for rnd, (w_sum, w_err) in enumerate(want):
        for rank in range(world):
            s, e = per_rank[rank][(case, route)][rnd]
            for (name, ws), (_, gs) in zip(_flat(w_sum), _flat(s),
                                           strict=True):
                assert gs.dtype == torch.float32
                assert np.array_equal(_bits(ws[rank]), _bits(gs.numpy())), (
                    f"round {rnd} rank {rank} sum {name}")
            for (name, we), (_, ge) in zip(_flat(w_err), _flat(e),
                                           strict=True):
                assert np.array_equal(_bits(we[rank]), _bits(ge.numpy())), (
                    f"round {rnd} rank {rank} error {name}")


def test_ties_round_half_to_even(ranks):
    """The tree case's first round: scale 1 exactly, so rank 0's halves
    quantize to the even neighbour (64, -0, 0, 2, 2) before the sum."""
    world, per_rank = ranks
    s, e = per_rank[0][("tree", "name")][0]
    q_other = np.array([1, 0, 2, -2, 0, 4], np.float32)
    want = np.array([127, 64, 0, 0, 2, 2], np.float32) + (world - 1) * q_other
    assert np.array_equal(s["w"]["ties"].numpy(), want)
    assert np.array_equal(e["w"]["ties"].numpy(), np.array(
        [0, -0.5, -0.5, 0.5, -0.5, 0.5], np.float32))


def test_axis_name_needs_a_mesh():
    with pytest.raises(ValueError, match="no mesh is set"):
        C.ef_psum(torch.ones(3), torch.zeros(3), "data")
