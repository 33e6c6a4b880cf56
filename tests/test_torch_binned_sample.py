"""K2 (binned slab sampler) of the port against parcels_tpu's, same inputs.

The port's plan and the plain version of its K2 are held, end to end, to
the JAX ``binned_linear_sample`` (forced, Pallas in
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


def _plain_count(data, plan):
    """The lanes K2's plain version counts as read partly from the field."""
    counter = torch.zeros(1, dtype=torch.int64, device=data.device)
    tbs.slab_sample_plain(data, plan, counter)
    return int(counter)


def _k2(data, plan, staged=None):
    """K2's values, and the lanes it counts as read partly from the field."""
    counter = torch.zeros(1, dtype=torch.int64, device=data.device)
    return tbs.slab_sample(data, plan, staged, counter), int(counter)


def _overflow_brute(plan, shape4):
    """Per lane, in numpy from each sub-block's window: a lane of a live
    chunk with a corner (clamped to the field) outside its window."""
    n, ext = plan["n"], (plan["geom"][0], plan["WZ"], *plan["geom"][2:4])
    wins = _windows_brute(plan)
    sub = np.arange(n) // tbs.LANE
    live = np.array([w is not None for w in wins])[sub]
    org = np.array([(w[0][0], w[1], w[0][1], w[0][2]) if w else (0, 0, 0, 0) for w in wins])[sub]
    far = np.zeros(n, bool)
    for a, (idx, d) in enumerate(zip(plan["index"], shape4)):
        idx = idx.cpu().numpy().astype(np.int64)
        for c in (np.clip(idx, 0, d - 1), np.clip(idx + (d > 1), 0, d - 1)):
            far |= (c < org[:, a]) | (c >= org[:, a] + ext[a])
    return far & live


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
    """Unsorted lanes overflow massively: K2 reads their corners from the
    field; still exact."""
    shape4 = (2, 6, 48, 640)
    rng = np.random.default_rng(5)
    data = rng.uniform(-1, 1, shape4).astype(np.float32)
    got, want, tg = _both(data, _random_positions(rng, 4096, shape4))
    assert _plain_count(torch.as_tensor(data), tbs._get_plan(shape4, tg)) > 4096 // 8
    np.testing.assert_allclose(got, want, **TOL)


def test_binned_partial_overflow_matches_reference():
    """A few far-away lanes inside sorted chunks overflow their windows."""
    shape4 = (2, 1, 64, 1024)
    rng = np.random.default_rng(7)
    data = rng.uniform(-1, 1, shape4).astype(np.float32)
    n = 6000
    pos = _sort_positions(_random_positions(rng, n, shape4), shape4)
    lanes = rng.choice(n, 50, replace=False)
    pos["Y"][0][lanes] = rng.integers(0, 63, 50)
    pos["X"][0][lanes] = rng.integers(0, 1023, 50)
    got, want, tg = _both(data, pos)
    assert 50 <= _plain_count(torch.as_tensor(data), tbs._get_plan(shape4, tg)) <= 4096
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
    assert _plain_count(data, plan) / n < 0.05, "sorted lanes must lie inside their windows"
    vals = tbs.slab_sample_plain(data, plan)[:n]
    ref = tbs._gather16(data, tbs._gather_lanes(tg))
    ok = ~tbs._overflow_lanes(plan, shape4)
    np.testing.assert_allclose(vals[ok].numpy(), ref[ok].numpy(), **TOL)


def test_plain_equals_gather_bit_for_bit_on_live_lanes():
    """On the inputs of test_plain_equals_gather_on_window_lanes, K2's plain
    version equals ``_gather16`` bit for bit on every lane inside its window,
    and the sampler equals it on every lane: whether a lane overflows its
    window, and which chunk it shares, changes no bit."""
    shape4 = (2, 16, 64, 512)
    rng = np.random.default_rng(11)
    data = torch.as_tensor(rng.uniform(-1, 1, shape4).astype(np.float32))
    n = 64 * tbs.CHUNK
    pos = _sort_positions(_random_positions(rng, n, shape4), shape4)
    tg = {ax: {"index": torch.as_tensor(i), "bcoord": torch.as_tensor(b)} for ax, (i, b) in pos.items()}
    plan = tbs._build_plan(shape4, tg)
    ref = tbs._gather16(data, tbs._gather_lanes(tg))
    ok = ~tbs._overflow_lanes(plan, shape4)
    assert ok.sum() > 0.95 * n
    assert torch.equal(tbs.slab_sample_plain(data, plan)[ok], ref[ok])
    tg["_sorted"] = True
    assert torch.equal(tbs.binned_linear_sample(data, tg), ref)
    # the same lanes in chunks of another composition: the first 100 lanes dropped
    part = {ax: {k: v[100:] for k, v in d.items()} for ax, d in tg.items() if ax in "TZYX"}
    part["_sorted"] = True
    assert torch.equal(tbs.binned_linear_sample(data, part), ref[100:])


def _overflow_inputs(kind):
    """(data, gpos) of the sorted, partial-overflow and unsorted tests above,
    with the last chunk's lanes dead."""
    if kind == "sorted":
        shape4, n, seed = (2, 16, 64, 512), 64 * tbs.CHUNK, 11
    elif kind == "partial":
        shape4, n, seed = (2, 1, 64, 1024), 6000, 7
    else:
        shape4, n, seed = (2, 6, 48, 640), 4096, 5
    rng = np.random.default_rng(seed)
    data = torch.as_tensor(rng.uniform(-1, 1, shape4).astype(np.float32))
    pos = _random_positions(rng, n, shape4)
    if kind != "unsorted":
        pos = _sort_positions(pos, shape4)
    if kind == "partial":
        lanes = rng.choice(n, 50, replace=False)
        pos["Y"][0][lanes] = rng.integers(0, 63, 50)
        pos["X"][0][lanes] = rng.integers(0, 1023, 50)
    tg = {ax: {"index": torch.as_tensor(i), "bcoord": torch.as_tensor(b)} for ax, (i, b) in pos.items()}
    tg["active"] = torch.arange(n) < (n - 1) // tbs.CHUNK * tbs.CHUNK
    return data, tg


@pytest.mark.parametrize("kind", ["sorted", "partial", "unsorted"])
def test_plain_equals_gather_bit_for_bit_on_every_lane_of_live_chunks(kind):
    """K2's plain version equals ``_gather16`` bit for bit on every lane of
    every live chunk, overflow lanes (a corner outside the window, read from
    the field) among them; dead chunks give 0."""
    data, tg = _overflow_inputs(kind)
    plan = tbs._build_plan(tuple(data.shape), tg)
    n = plan["n"]
    flags = tbs._overflow_lanes(plan, data.shape)
    assert np.array_equal(flags.numpy(), _overflow_brute(plan, data.shape))
    assert _plain_count(data, plan) == int(flags.sum()) > 0
    live = plan["live"][torch.arange(n) // tbs.CHUNK] == 1
    assert live.any() and not live.all()
    vals = tbs.slab_sample_plain(data, plan)
    ref = tbs._gather16(data, tbs._gather_lanes(tg))
    assert torch.equal(vals[live], ref[live])
    assert torch.all(vals[~live] == 0)


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
    assert not tbs._overflow_lanes(plan, shape4)[tbs.CHUNK:].any()
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


def _same_bits(a, b):
    return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def test_kernel_matches_plain_on_card():
    """Bit for bit on the card: sorted lanes; scripted window sequences (z
    moves of 0, 1, 2 and WZ or more planes, a change of half mid-chunk,
    consecutive chunks with equal origins, dead chunks) by bulk copies
    (X = 520) and by the scalar staging path (X = 517); planned lanes with
    X % 4 != 0 and dead chunks. On each, K2 counts the lanes it reads
    partly from the field as its plain version counts them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    shape4 = (2, 16, 64, 512)
    rng = np.random.default_rng(2)
    data = torch.as_tensor(rng.uniform(-1, 1, shape4).astype(np.float32), device="cuda")
    pos = _sort_positions(_random_positions(rng, 64 * tbs.CHUNK, shape4), shape4)
    tg = {ax: {"index": torch.as_tensor(i, device="cuda"),
               "bcoord": torch.as_tensor(b, device="cuda")} for ax, (i, b) in pos.items()}
    plan = tbs._build_plan(shape4, tg)
    got, count = _k2(data, plan)
    assert torch.equal(got, tbs.slab_sample_plain(data, plan))
    # K2 counts the lanes its plain version counts
    assert count == _plain_count(data, plan)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for X in (520, 517):
        plan = tbs.edge_plans(X, device="cuda")
        data = torch.as_tensor(rng.uniform(-1, 1, (3, 12, 40, X)).astype(np.float32), device="cuda")
        staged = torch.zeros(1, dtype=torch.int64, device="cuda")
        got, count = _k2(data, plan, staged)
        assert _same_bits(got, tbs.slab_sample_plain(data, plan)), X
        assert count == _plain_count(data, plan) > 0, X
        # the copies the kernel issued are what the host counts
        assert int(staged) == tbs.staged_bytes(plan, sms), X
    shape4 = (2, 6, 40, 1101)
    data = torch.as_tensor(rng.uniform(-1, 1, shape4).astype(np.float32), device="cuda")
    n = 20 * tbs.CHUNK
    pos = _sort_positions(_random_positions(rng, n, shape4), shape4)
    tg = {ax: {"index": torch.as_tensor(i, device="cuda"),
               "bcoord": torch.as_tensor(b, device="cuda")} for ax, (i, b) in pos.items()}
    tg["active"] = torch.arange(n, device="cuda") < n - 3 * tbs.CHUNK
    plan = tbs._build_plan(shape4, tg)
    got, count = _k2(data, plan)
    assert _same_bits(got, tbs.slab_sample_plain(data, plan))
    assert count == _plain_count(data, plan)


def test_kernel_equals_gather_on_card():
    """On the card, K2 alone equals ``_gather16`` bit for bit on every lane of
    every live chunk of the scripted plans (bulk and scalar staging; corners
    outside the window and outside the field) and of an unsorted plan, and
    its copies are still only the windows' (``staged_bytes``); the sampler
    makes no host read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def live_lanes(plan):
        return plan["live"][torch.arange(plan["n"], device="cuda") // tbs.CHUNK] == 1

    for X in (520, 517):
        plan = tbs.edge_plans(X, device="cuda")
        data = torch.as_tensor(rng.uniform(-1, 1, (3, 12, 40, X)).astype(np.float32), device="cuda")
        staged = torch.zeros(1, dtype=torch.int64, device="cuda")
        got = tbs.slab_sample(data, plan, staged)
        gidx = {ax: (i.to(torch.int64), b) for ax, i, b in zip("TZYX", plan["index"], plan["bcoord"])}
        ref = tbs._gather16(data, gidx)
        live = live_lanes(plan)
        assert _same_bits(got[live], ref[live]), X
        assert int(staged) == tbs.staged_bytes(plan, sms), X
    data, tg = _overflow_inputs("unsorted")
    data = data.cuda()
    tg = {ax: {k: v.cuda() for k, v in d.items()} if isinstance(d, dict) else d.cuda()
          for ax, d in tg.items()}
    plan = tbs._build_plan(tuple(data.shape), tg)
    live = live_lanes(plan)
    ref = tbs._gather16(data, tbs._gather_lanes(tg))
    assert _same_bits(tbs.slab_sample(data, plan)[live], ref[live])
    tg["_sorted"] = True
    torch.cuda.synchronize()
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tbs.binned_linear_sample(data, tg)
    finally:
        torch.cuda.set_sync_debug_mode(old)
    assert _same_bits(got[live], ref[live])


# ---------------------------------------------------------------------------
# staged_bytes: what the kernel stages, counted on the host
# ---------------------------------------------------------------------------


def _windows_brute(plan):
    """Per sub-block ((t0, y, x) origin, z origin), or None in a dead chunk."""
    out = []
    for q in range(plan["G"] * plan["NS"]):
        g = q // plan["NS"]
        if not int(plan["live"][g]):
            out.append(None)
            continue
        h = "2" if int(plan["shalf"][q]) else "1"
        o = {a: int(plan["origins"][a + h][g]) for a in "zyx"}
        out.append(((int(plan["t0"][g]), o["y"], o["x"]), o["z"] + int(plan["z0w"][q])))
    return out


def _staged_brute(plan, sms):
    """The kernel's staging rule, plane by plane: groups of at most
    GROUP_SUBBLOCKS consecutive live sub-blocks of one origin spanning at
    most ring_planes planes; a group stages the (origin, plane) pairs the
    previous group of its block did not hold."""
    WT, _, SY, SX = plan["geom"][:4]
    WZ, RZ = plan["WZ"], tbs.ring_planes(plan["geom"])
    wins = _windows_brute(plan)
    G, NS = plan["G"], plan["NS"]
    blocks = tbs.k2_grid(G, sms)
    staged = 0
    for b in range(blocks):
        # the kernel's block b walks chunks [b G / blocks, (b + 1) G / blocks)
        blk, held, k = wins[b * G // blocks * NS:(b + 1) * G // blocks * NS], set(), 0
        while k < len(blk):
            if blk[k] is None:
                k += 1
                continue
            members = [blk[k]]
            while len(members) < tbs.GROUP_SUBBLOCKS and k + len(members) < len(blk):
                nxt = blk[k + len(members)]
                if nxt is None or nxt[0] != members[0][0]:
                    break
                zs = [z for _, z in members + [nxt]]
                if max(zs) + WZ - min(zs) > RZ:
                    break
                members.append(nxt)
            span = {(members[0][0], z) for _, z0 in members for z in range(z0, z0 + WZ)}
            staged += len(span - held)
            held = span
            k += len(members)
    return 4 * WT * SY * SX * staged


def _staged_whole_windows(plan):
    """What a kernel stages that loads a whole window at each chunk's first
    live sub-block and at every change of (half, z0w) inside a chunk."""
    WT, _, SY, SX = plan["geom"][:4]
    NS = plan["NS"]
    keys = list(zip(plan["shalf"].tolist(), plan["z0w"].tolist()))
    n = 0
    for g in range(plan["G"]):
        if int(plan["live"][g]):
            ks = keys[g * NS:(g + 1) * NS]
            n += 1 + sum(a != b for a, b in zip(ks, ks[1:]))
    return 4 * WT * plan["WZ"] * SY * SX * n


def _plans():
    rng = np.random.default_rng(13)
    out = {"scripted": tbs.edge_plans(520)}
    for shape4, dead in (((2, 16, 64, 512), 0), ((3, 12, 40, 640), 2)):
        n = 24 * tbs.CHUNK
        pos = _sort_positions(_random_positions(rng, n, shape4), shape4)
        tg = {ax: {"index": torch.as_tensor(i), "bcoord": torch.as_tensor(b)}
              for ax, (i, b) in pos.items()}
        tg["active"] = torch.arange(n) < n - dead * tbs.CHUNK
        out[f"sorted{shape4}"] = tbs._build_plan(shape4, tg)
    return out


@pytest.mark.parametrize("sms", [1000, 4, 2, 1])
@pytest.mark.parametrize("name", ["scripted", "sorted(2, 16, 64, 512)", "sorted(3, 12, 40, 640)"])
def test_staged_bytes_matches_brute_force(name, sms):
    """One chunk a block (1000 SMs) down to two blocks for the whole plan."""
    plan = _plans()[name]
    staged = tbs.staged_bytes(plan, sms)
    assert staged == _staged_brute(plan, sms)
    # never more than restaging every window change
    assert 0 < staged <= _staged_whole_windows(plan)


def test_staged_bytes_full_window_when_every_sub_block_changes_half():
    """Halves with different y origins, alternating at every sub-block:
    every sub-block loads its whole window."""
    G, NS = 6, tbs.CHUNK // tbs.LANE
    geom = (2, 8, 16, 128)
    live = [1, 1, 0, 1, 1, 1]
    plan = tbs.scripted_plan((3, 12, 60, 512), geom, [0] * G, [(0, 4, 64)] * G,
                             [(2, 30, 64)] * G, [0, 1] * (G * NS // 2), [1] * (G * NS), live)
    window = 4 * 2 * 4 * 16 * 128
    for sms in (1000, 1):
        assert tbs.staged_bytes(plan, sms) == sum(live) * NS * window == _staged_whole_windows(plan)
