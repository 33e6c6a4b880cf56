"""K2 (binned slab sampler) of the port against parcels_tpu's, same inputs.

The port's plan, the plain version of its K2 and its overflow fix-up are
held, end to end, to the JAX ``binned_linear_sample`` (forced, Pallas in
interpret mode) on the shapes of tests/test_binned_sample.py, at
rtol 2e-4 / atol 2e-5: the JAX package's own tolerance there, which covers
its bf16 hi/lo matrix-unit split (~1e-5 relative). The two planners size
their slabs for different hardware, so their plans differ; the values
must not.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parcels_tpu.ops import binned_sample as jbs
from parcels_tpu_torch.ops import binned_sample as tbs

TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _force_binned(monkeypatch):
    monkeypatch.setenv("PARCELS_TPU_BINNED", "force")


def _random_positions(rng, n, shape4):
    pos = {}
    for ax, dim in zip("TZYX", shape4):
        idx = rng.integers(0, max(dim - 1, 1), n)
        bc = rng.uniform(0, 1, n).astype(np.float32)
        if dim == 1:
            idx, bc = np.zeros(n, np.int64), np.zeros(n, np.float32)
        pos[ax] = (idx.astype(np.int32), bc)
    return pos


def _sort_positions(pos, shape4):
    """Order lanes by the port's (bin, z-cell) key, as the port's engine does."""
    gpos = {ax: {"index": torch.as_tensor(idx)} for ax, (idx, _) in pos.items()}
    key = tbs.sort_key_for(None, gpos, shape4, len(pos["X"][0])).numpy()
    order = np.argsort(key, kind="stable")
    return {ax: (idx[order], bc[order]) for ax, (idx, bc) in pos.items()}


def _both(data, pos):
    jg = {ax: {"index": jnp.asarray(i), "bcoord": jnp.asarray(b)} for ax, (i, b) in pos.items()}
    jg["_sorted"] = True
    tg = {ax: {"index": torch.as_tensor(i), "bcoord": torch.as_tensor(b)} for ax, (i, b) in pos.items()}
    tg["_sorted"] = True
    want = np.asarray(jbs.binned_linear_sample(jnp.asarray(data), jg))
    got = tbs.binned_linear_sample(torch.as_tensor(data), tg).numpy()
    return got, want, tg


@pytest.mark.parametrize(
    "shape4, lockstep",
    [((2, 4, 16, 256), False), ((3, 1, 32, 384), False), ((2, 8, 40, 512), False),
     ((1, 1, 16, 256), False), ((4, 2, 32, 384), True)],
)
def test_binned_matches_reference_sorted(shape4, lockstep):
    rng = np.random.default_rng(3)
    data = rng.uniform(-1, 1, shape4).astype(np.float32)
    n = 3000
    pos = _sort_positions(_random_positions(rng, n, shape4), shape4)
    if lockstep:  # every lane at one (ti, tau), as a lockstep batch
        pos["T"] = (np.full(n, 1, np.int32), np.full(n, 0.375, np.float32))
    got, want, _ = _both(data, pos)
    np.testing.assert_allclose(got, want, **TOL)


def test_binned_unsorted_matches_reference():
    """Unsorted lanes overflow massively -> the full-gather tier; still exact."""
    shape4 = (2, 6, 48, 640)
    rng = np.random.default_rng(5)
    data = rng.uniform(-1, 1, shape4).astype(np.float32)
    got, want, tg = _both(data, _random_positions(rng, 4096, shape4))
    assert tbs._get_plan(shape4, tg)["count"] > 4096 // 8
    np.testing.assert_allclose(got, want, **TOL)


def test_binned_partial_overflow_matches_reference():
    """A few far-away lanes inside sorted chunks take the K-capacity fix-up."""
    shape4 = (2, 1, 64, 1024)
    rng = np.random.default_rng(7)
    data = rng.uniform(-1, 1, shape4).astype(np.float32)
    n = 6000
    pos = _sort_positions(_random_positions(rng, n, shape4), shape4)
    lanes = rng.choice(n, 50, replace=False)
    pos["Y"][0][lanes] = rng.integers(0, 63, 50)
    pos["X"][0][lanes] = rng.integers(0, 1023, 50)
    got, want, tg = _both(data, pos)
    assert 50 <= tbs._get_plan(shape4, tg)["count"] <= 4096
    np.testing.assert_allclose(got, want, **TOL)


def test_plain_equals_gather_on_window_lanes():
    """K2's plain version equals the plain gather on every non-overflow live
    lane, at the JAX package's tolerance: K2 carries each slab-relative
    position as one f32 (index + bcoord), whose rounding near 512 is ~3e-5."""
    shape4 = (2, 16, 64, 512)
    rng = np.random.default_rng(11)
    data = torch.as_tensor(rng.uniform(-1, 1, shape4).astype(np.float32))
    n = 64 * tbs.CHUNK
    pos = _sort_positions(_random_positions(rng, n, shape4), shape4)
    tg = {ax: {"index": torch.as_tensor(i), "bcoord": torch.as_tensor(b)} for ax, (i, b) in pos.items()}
    plan = tbs._build_plan(shape4, tg)
    assert plan["count"] / n < 0.05, "sorted lanes must ride the kernel, not the fix-up"
    vals = tbs.slab_sample_plain(data, plan)[:n]
    ref = tbs._gather16(data, tbs._gather_lanes(tg))
    ok = ~plan["overflow"]
    np.testing.assert_allclose(vals[ok].numpy(), ref[ok].numpy(), **TOL)


def test_dead_chunks_write_zero():
    shape4 = (2, 4, 16, 256)
    rng = np.random.default_rng(1)
    data = torch.as_tensor(rng.uniform(-1, 1, shape4).astype(np.float32))
    n = 3 * tbs.CHUNK
    pos = _random_positions(rng, n, shape4)
    tg = {ax: {"index": torch.as_tensor(i), "bcoord": torch.as_tensor(b)} for ax, (i, b) in pos.items()}
    active = torch.ones(n, dtype=torch.bool)
    active[tbs.CHUNK:] = False
    tg["active"] = active
    plan = tbs._build_plan(shape4, tg)
    assert plan["live"].tolist() == [1, 0, 0]
    assert not plan["overflow"][tbs.CHUNK:].any()
    assert torch.all(tbs.slab_sample_plain(data, plan)[tbs.CHUNK:] == 0)


@pytest.mark.parametrize(
    "shape4, n",
    [((2, 50, 500, 500), 2_007_040), ((2, 50, 500, 500), 65536), ((3, 1, 3000, 4000), 10_000_000),
     ((1, 1, 16, 256), 1000), ((24, 1, 256, 1000), 1 << 20)],
)
def test_slab_geometry_properties(shape4, n):
    """The staged window fits a block's shared memory, and a lane inside its
    bin never reads outside its slab (+1 stencil, x origins aligned to 4)."""
    WT, SZ, SY, SX, bz, by, bx = tbs.slab_geometry(shape4, n)
    T, Z, Y, X = shape4
    assert WT == (1 if T == 1 else 2)
    assert 4 * WT * min(4, SZ) * SY * SX <= tbs.SMEM_WINDOW_BYTES
    assert SY <= Y and SX <= X and SZ <= Z
    assert (SY >= Y and by == Y) or by + 1 <= SY
    assert (SX >= X and bx == X) or bx + tbs.X_ALIGN <= SX
    if Z > 1:
        assert (SZ >= Z and bz == Z) or bz + 1 <= SZ


def test_slice_plan_is_feasible():
    """The 3-D end-to-end shape of the chip smoke run (2M particles padded
    to 2_007_040 lanes) plans feasibly."""
    assert tbs.plan_feasible((2, 50, 500, 500), 2_007_040)


def test_sort_key_groups_bins():
    shape4 = (2, 10, 64, 512)
    n = 100_000
    _, _, _, _, bz, by, bx = tbs.slab_geometry(shape4, n)
    gpos = {
        "Z": {"index": torch.tensor([0, 0, bz * 3])},
        "Y": {"index": torch.tensor([0, by - 1, by])},
        "X": {"index": torch.tensor([0, bx - 1, bx])},
    }
    key = tbs.sort_key_for(None, gpos, shape4, n).numpy()
    assert key[0] == key[1]
    assert key[2] != key[0]


def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    shape4 = (2, 16, 64, 512)
    rng = np.random.default_rng(2)
    data = torch.as_tensor(rng.uniform(-1, 1, shape4).astype(np.float32), device="cuda")
    pos = _sort_positions(_random_positions(rng, 64 * tbs.CHUNK, shape4), shape4)
    tg = {ax: {"index": torch.as_tensor(i, device="cuda"),
               "bcoord": torch.as_tensor(b, device="cuda")} for ax, (i, b) in pos.items()}
    plan = tbs._build_plan(shape4, tg)
    got = tbs.slab_sample(data, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, tbs.slab_sample_plain(data, plan))
