"""K5, the C-grid stage cache's check, search and gather (ops/cgrid_repair.py).

The plain versions (which the CPU runs) are held to the JAX package's
``cgrid_cached_eval`` and ``_full`` on the CPU: a first full eval, then one
stage whose ~2900 misses at n = 4096 take three rounds of K = 1024, the
last short and padded with lane n - 1, a dead lane that moved, so it walks.
On the MOi-like spherical grid and on the rotated flat grid, where lanes
outside the lookup raster (hopeless, walking their round's count) sit in
every round. ``cgrid_stage_plain`` (a stage: the hit check, the repair and
every lane's (xsi, eta)) is held to the same stage of the JAX package
directly, and on the rotated grid in the pad and round cases: a pad lane
that is a hit, a pad lane that is already a miss, whole rounds, no miss and
every lane a miss. The search columns must be equal, the quads within
``tests/test_torch_curvilinear.py``'s C-grid tolerance and (xsi, eta) within
its ``BC_ATOL``. The work list the check kernel forms (``work_list``) and
the device-side plan (``repair_plan``) must form the plain loop's rounds
exactly. On a card, the kernel is held to the plain versions bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu._core.field import VectorField as JVectorField
from parcels_tpu._core.particles_view import Particles as JParticles
from parcels_tpu.datasets import curvilinear_rotated_dataset as j_rotated
from parcels_tpu.datasets import moi_like_fieldset as j_moi
from parcels_tpu.ops import stagecache as jsc
from parcels_tpu_torch._core import index_search as tis
from parcels_tpu_torch._core.field import VectorField as TVectorField
from parcels_tpu_torch._core.particles_view import Particles as TParticles
from parcels_tpu_torch.datasets import curvilinear_rotated_dataset as t_rotated
from parcels_tpu_torch.datasets import moi_like_fieldset as t_moi
from parcels_tpu_torch.ops import cgrid_repair, stagecache

N = 4096
K = 1024
SEARCH_COLS = ("cell", "yi", "xi", "esc", "oob")
#: (xsi, eta) of lanes in a cell: tests/test_torch_curvilinear.py's BC_ATOL
BC_ATOL = 2e-5
QUAD_COLS = ("u4", "v4", "w4", "row")


def _fieldsets(grid, device="cpu"):
    """(JAX fieldset or None, port fieldset, vector field name)."""
    if grid == "moi":
        tfs = t_moi(xdim=96, ydim=64, zdim=3, seed=2, with_w=True, device=device)
        jfs = j_moi(xdim=96, ydim=64, zdim=3, seed=2, with_w=True) if device == "cpu" else None
        return jfs, tfs, "UVW"
    tfs = tp.FieldSet.from_sgrid_conventions(t_rotated(xdim=50, ydim=40), mesh="flat",
                                             device=device)
    tfs.add_field(TVectorField("UVc", tfs.U, tfs.V, interp_method=tp.CGrid_Velocity()))
    jfs = None
    if device == "cpu":
        jfs = jp.FieldSet.from_sgrid_conventions(j_rotated(xdim=50, ydim=40), mesh="flat")
        jfs.add_field(JVectorField("UVc", jfs.U, jfs.V, interp_method=jp.CGrid_Velocity()))
    return jfs, tfs, "UVc"


def _stage_inputs(grid, g):
    """Positions of a first eval and of the stage after it; the second moves
    ~72 % of the lanes by one to two cells, and lane n - 1 (dead) too."""
    rng = np.random.default_rng(11)
    if grid == "moi":
        x = rng.uniform(-170, 170, N)
        y = rng.uniform(-60, 70, N)
        step = 4.0  # a MOi cell here spans 3.75 deg of longitude
    else:
        # inside the rotated grid's cells (its lon/lat box is wider)
        ny, nx = g.lon.shape
        yi, xi = rng.integers(0, ny - 1, N), rng.integers(0, nx - 1, N)
        a, b = rng.uniform(0.05, 0.95, N), rng.uniform(0.05, 0.95, N)

        def bilinear(v):
            return ((1 - a) * (1 - b) * v[yi, xi] + a * (1 - b) * v[yi, xi + 1]
                    + a * b * v[yi + 1, xi + 1] + (1 - a) * b * v[yi + 1, xi])

        x, y = bilinear(g.lon), bilinear(g.lat)
        hi_x, lo_x = g.lon.max(), g.lon.min()
        step = 1000.0  # the cell size
    moved = rng.random(N) < 0.72
    moved[-1] = True

    def shift():  # one to two cells either way
        return rng.choice([-1.0, 1.0], N) * rng.uniform(step, 2 * step, N)

    x2 = np.where(moved, x + shift(), x)
    y2 = np.where(moved, y + shift(), y)
    if grid == "rotated":
        # every 10th moved lane leaves the lookup raster (its bounds padded
        # 1 % beyond the grid): hopeless, it walks its round's count
        far = moved & (np.arange(N) % 10 == 3)
        x2 = np.where(far, hi_x + 0.2 * (hi_x - lo_x) + rng.uniform(0, 5e3, N), x2)
    t = np.full(N, 3600.0)
    z = np.full(N, 1.0)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return f32(t), f32(z), f32(y), f32(x), f32(y2), f32(x2)


def _pdata(lib, n, ngrids):
    zeros = (lambda s, d: jnp.zeros(s, d)) if lib == "jax" else (
        lambda s, d: torch.zeros(s, dtype=d))
    i32 = jnp.int32 if lib == "jax" else torch.int32
    return {"state": zeros((n,), i32), "ei": zeros((n, ngrids), i32)}


def _columns(c):
    """Host copies of the cache columns (the repair writes them in place)."""
    return {k: np.array(c[k].cpu() if isinstance(c[k], torch.Tensor) else c[k])
            for k in SEARCH_COLS + QUAD_COLS + ("ti", "zi", "wzi") if c.get(k) is not None}


def _assert_columns(got, want, what):
    for k in SEARCH_COLS + ("ti", "zi", "wzi"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}: {k}")
    for k in QUAD_COLS:
        if k in want:
            b = want[k]
            # the C-grid tolerance of tests/test_torch_curvilinear.py
            np.testing.assert_allclose(got[k], b, rtol=2e-4, atol=2e-4 * np.abs(b).max(),
                                       err_msg=f"{what}: {k}")


@pytest.mark.parametrize("grid", ["moi", "rotated"])
def test_cgrid_repair_plain_matches_reference(monkeypatch, grid):
    monkeypatch.setenv("PARCELS_TPU_STAGECACHE", "force")
    jfs, tfs, name = _fieldsets(grid)
    t, z, y, x, y2, x2 = _stage_inputs(grid, tfs.gridset[0])
    mask = np.ones(N, bool)
    mask[-1] = False  # a dead lane: never a miss, but the last round's pad

    jvf = getattr(jfs.build_views(jfs.device_arrays()), name)
    tvf = getattr(tfs.build_views(tfs.device_arrays()), name)
    assert jsc.enabled(jvf) and stagecache.enabled(tvf)
    jd, td = _pdata("jax", N, len(jfs.gridset)), _pdata("torch", N, len(tfs.gridset))
    jpart, tpart = JParticles(jd, jnp.asarray(mask)), TParticles(td, torch.as_tensor(mask))
    T = torch.as_tensor

    # the first eval: _full over every lane
    jsc.cgrid_cached_eval(jvf, t, z, y, x, jpart)
    stagecache.cgrid_cached_eval(tvf, T(t), T(z), T(y), T(x), tpart)
    first = _columns(tvf._stage_cache)
    _assert_columns(first, _columns(jvf._stage_cache), f"{grid} first eval")

    # the repaired stage: three rounds of K, the last short and padded
    tc = tvf._stage_cache
    q = tis.query_xyz(T(y2), T(x2), tfs.gridset[0].spec.spherical)
    ok, _, _ = tis.pic_from_rows(tc["row"], q)
    miss = ~ok & T(mask)
    rounds = list(cgrid_repair.plain_rounds(miss, K))
    assert len(rounds) == 3 and 0 < int(miss.sum()) % K and not bool(miss[-1])
    assert all(int(r[-1]) == N - 1 for r in rounds[-1:])
    if grid == "rotated":
        g = tfs.gridset[0]
        lo_x, step_x = g.lookup_meta()["origin"][1], g.lookup_meta()["step"][1]
        outside = T(x2) > lo_x + step_x * g._lookup["xi"].shape[1]
        assert all(bool(outside[r.long()].any()) for r in rounds)

    before = stagecache.cgrid_cached_eval.miss_rounds
    jsc.cgrid_cached_eval(jvf, t, z, y2, x2, jpart)
    stagecache.cgrid_cached_eval(tvf, T(t), T(z), T(y2), T(x2), tpart)
    assert stagecache.cgrid_cached_eval.miss_rounds - before == 3
    got = _columns(tvf._stage_cache)
    _assert_columns(got, _columns(jvf._stage_cache), f"{grid} repaired stage")
    # the pad lane walked to a new cell; the outside lanes ended out of bounds
    assert got["cell"][-1] != first["cell"][-1]
    if grid == "rotated":
        lost = outside.numpy() & miss.numpy()
        assert (got["esc"][lost] == int(tp.StatusCode.ErrorOutOfBounds)).all()


def _plan_cases():
    rng = np.random.default_rng(5)
    cases = {}
    for name, n, k, share, last in (
        ("three rounds, short, pad not a miss", 4096, 1024, 0.7, False),
        ("three rounds, short, last lane a miss", 4096, 1024, 0.7, True),
        ("whole rounds", 4096, 1024, None, False),
        ("one short round", 3000, 1024, 0.05, False),
        ("no miss", 2048, 1024, 0.0, False),
        ("every lane", 2048, 1024, 1.0, True),
    ):
        if share is None:
            miss = np.zeros(n, bool)
            miss[rng.choice(n - 1, 2 * k, replace=False)] = True
        else:
            miss = rng.random(n) < share
        miss[-1] = last if share != 0.0 else False
        cases[name] = (torch.as_tensor(miss), k)
    return cases


@pytest.mark.parametrize("case", list(_plan_cases()))
def test_repair_plan_forms_the_plain_rounds(case):
    """The device-side plan (each miss's rank by a cumsum, its round rank // K,
    the pad lane n - 1 in a short last round) equals the rounds the plain
    loop forms, lane for lane."""
    miss, k = _plan_cases()[case]
    slot, cnt, rounds = cgrid_repair.repair_plan(miss, k)
    plain = list(cgrid_repair.plain_rounds(miss, k))
    assert int(cnt) == int(miss.sum()) and int(rounds) == len(plain)
    assert slot.dtype == torch.int32 and slot.shape == miss.shape
    for r, idx in enumerate(plain):
        assert idx.shape[0] == k
        lanes = torch.nonzero(slot == r).squeeze(1)
        assert torch.equal(lanes, torch.unique(idx.long())), r
    assert int((slot >= 0).sum()) == len(torch.unique(torch.cat(plain))) if plain else \
        int((slot >= 0).sum()) == 0


def test_wrappers_run_the_plain_version_on_the_cpu(monkeypatch):
    """On CPU tensors the wrappers are their plain versions and launch nothing."""
    monkeypatch.setenv("PARCELS_TPU_STAGECACHE", "force")
    _, tfs, name = _fieldsets("rotated")
    vf = getattr(tfs.build_views(tfs.device_arrays()), name)
    t, z, y, x, y2, x2 = (torch.as_tensor(a[:512]) for a in _stage_inputs("rotated",
                                                                          tfs.gridset[0]))
    n = y.shape[0]
    zero = torch.zeros(n, dtype=torch.int32)
    q = tis.query_xyz(y2, x2, False)
    launches = cgrid_repair.launches
    got = cgrid_repair.cgrid_full(vf, y2, x2, q, zero, zero + 1, zero, zero, zero, zero)
    want = cgrid_repair.cgrid_full_plain(vf, y2, x2, zero, zero + 1, zero, zero, zero, zero)
    for k in cgrid_repair.COLUMNS + ("xsi", "eta"):
        if want[k] is not None:
            assert torch.equal(got[k], want[k]), k
    c = {k: v.clone() for k, v in want.items() if v is not None} | {"w4": None}
    c.update(ti=zero.clone(), zi=zero.clone(), wzi=zero.clone(), cell=zero - 1)
    st = cgrid_repair.cgrid_stage(vf, c, y, x, tis.query_xyz(y, x, False), zero, zero + 1, zero,
                                  zero, None, 128)
    assert (st.cnt, st.rounds, st.length) == (n, 4, n)
    assert torch.equal(st.work, torch.arange(n, dtype=torch.int32))
    assert cgrid_repair.launches == launches


# ---------------------------------------------------------------------------
# one stage (cgrid_stage_plain) against the JAX package's cached eval
# ---------------------------------------------------------------------------


def _jax_stage(jvf, jpart, t, z, y2, x2, keys, spherical, invalid):
    """The JAX package's cached eval of a stage after its first eval: its
    miss count (its check's expressions, on the stage's time and depth
    ``keys``, taken before the stage), then the cache columns and (xsi,
    eta) it ends with."""
    from parcels_tpu._core import index_search as jis

    c = jvf._stage_cache
    if invalid:
        c["cell"] = jnp.full_like(c["cell"], -1)
    q = jis.query_xyz(jnp.asarray(y2), jnp.asarray(x2), spherical)
    ok, _, _ = jis.pic_from_rows(c["row"], q)
    ti, zc, wzi = (jnp.asarray(k) for k in keys)
    hit = ok & (ti == c["ti"]) & (zc == c["zi"]) & (wzi == c["wzi"]) & (c["cell"] >= 0)
    miss = ~hit & jnp.isfinite(jnp.asarray(y2)) & jnp.isfinite(jnp.asarray(x2)) & jpart._mask
    cnt = int(miss.sum())
    jsc.cgrid_cached_eval(jvf, t, z, y2, x2, jpart)
    c = jvf._stage_cache
    _, xsi, eta = jis.pic_from_rows(c["row"], q)
    return cnt, _columns(c), np.asarray(xsi), np.asarray(eta)


def _stage_case(grid, case):
    """Run a stage through both packages after a first eval on the same
    lanes. ``case`` picks which lanes move and the lane mask; returns
    (JAX (cnt, columns, xsi, eta), the port's StageResult and columns, miss)."""
    jfs, tfs, name = _fieldsets(grid)
    g = tfs.gridset[0]
    t, z, y, x, y2, x2 = _stage_inputs(grid, g)
    mask = np.ones(N, bool)
    if case == "no miss":
        y2, x2 = y, x
    if case == "pad a hit":
        y2[-1], x2[-1] = y[-1], x[-1]  # lane n - 1 stays in its cell
    jvf = getattr(jfs.build_views(jfs.device_arrays()), name)
    tvf = getattr(tfs.build_views(tfs.device_arrays()), name)
    jd, td = _pdata("jax", N, len(jfs.gridset)), _pdata("torch", N, len(tfs.gridset))
    T = torch.as_tensor
    stagecache.cgrid_cached_eval(tvf, T(t), T(z), T(y), T(x), TParticles(td, T(mask.copy())))
    jsc.cgrid_cached_eval(jvf, t, z, y, x, JParticles(jd, jnp.asarray(mask)))
    c = dict(tvf._stage_cache)
    invalid = case == "every lane"
    if invalid:
        c["cell"] = torch.full_like(c["cell"], -1)
    sph = g.spec.spherical
    q = tis.query_xyz(T(y2), T(x2), sph)
    ti, t1i, _, _, _, zc, _, wzi, _ = stagecache.stage_brackets(tvf, T(t), T(z))
    miss = cgrid_repair.stage_miss(c, T(y2), T(x2), q, ti, zc, wzi, T(mask))
    if case == "whole rounds":  # the mask keeps 2 K of the misses: no pad
        keep = torch.nonzero(miss).squeeze(1)[:2 * K]
        mask[:] = False
        mask[keep.numpy()] = True
        miss = miss & T(mask)
    keys = tuple(k.numpy() for k in (ti, zc, wzi))
    j = _jax_stage(jvf, JParticles(jd, jnp.asarray(mask)), t, z, y2, x2, keys, sph, invalid)
    st = cgrid_repair.cgrid_stage_plain(tvf, c, T(y2), T(x2), q, ti, t1i, zc, wzi, T(mask), K)
    return j, st, _columns(c), miss


STAGE_CASES = ("pad a hit", "pad a miss", "whole rounds", "no miss", "every lane")


@pytest.mark.parametrize("grid", ["moi", "rotated"])
def test_cgrid_stage_plain_matches_reference(monkeypatch, grid):
    """``cgrid_stage_plain`` (the new entry's plain version) against the JAX
    package's cached eval of the same stage: every cache column, (xsi, eta)
    within the curvilinear search's tolerance on the lanes in a cell, and
    the miss count and rounds (three rounds of K, the last short)."""
    monkeypatch.setenv("PARCELS_TPU_STAGECACHE", "force")
    (jcnt, jcols, jxsi, jeta), st, got, _ = _stage_case(grid, "pad a miss")
    _assert_columns(got, jcols, f"{grid} stage")
    assert (st.cnt, st.rounds) == (jcnt, -(-jcnt // K)) and st.rounds == 3
    inside = got["cell"] >= 0
    np.testing.assert_allclose(st.xsi.numpy()[inside], jxsi[inside], rtol=0, atol=BC_ATOL)
    np.testing.assert_allclose(st.eta.numpy()[inside], jeta[inside], rtol=0, atol=BC_ATOL)


@pytest.mark.parametrize("case", STAGE_CASES)
def test_cgrid_stage_plain_rounds_and_pad(monkeypatch, case):
    """The stage's pad and round cases on the rotated grid, against the JAX
    package: a short last round padded with a lane that is a hit (it is
    searched and written) or already a miss, whole rounds (no pad), no miss
    (nothing searched) and every lane a miss (invalid keys)."""
    monkeypatch.setenv("PARCELS_TPU_STAGECACHE", "force")
    (jcnt, jcols, jxsi, jeta), st, got, miss = _stage_case("rotated", case)
    _assert_columns(got, jcols, case)
    cnt = int(miss.sum())
    assert (st.cnt, st.rounds) == (jcnt, -(-jcnt // K)) and cnt == jcnt
    pad = bool(cnt % K) and not bool(miss[-1])
    assert st.length == cnt + pad
    assert {"pad a hit": pad and cnt > K, "pad a miss": bool(cnt % K) and bool(miss[-1]),
            "whole rounds": cnt == 2 * K, "no miss": cnt == 0,
            "every lane": cnt == N}[case]
    inside = got["cell"] >= 0
    np.testing.assert_allclose(st.xsi.numpy()[inside], jxsi[inside], rtol=0, atol=BC_ATOL)
    np.testing.assert_allclose(st.eta.numpy()[inside], jeta[inside], rtol=0, atol=BC_ATOL)


@pytest.mark.parametrize("case", list(_plan_cases()))
def test_work_list_forms_the_plain_rounds(case):
    """The work list (the check kernel's plan: the misses by rank, then the
    pad lane n - 1 of a short last round unless it is a miss) holds each
    round's lanes in ``plain_rounds``' order, and each lane's place // K is
    its ``repair_plan`` slot."""
    miss, k = _plan_cases()[case]
    work, cnt, rounds = cgrid_repair.work_list(miss, k)
    plain = list(cgrid_repair.plain_rounds(miss, k))
    slot, pcnt, prounds = cgrid_repair.repair_plan(miss, k)
    assert (cnt, rounds) == (int(pcnt), int(prounds)) == (int(miss.sum()), len(plain))
    for r, idx in enumerate(plain):
        lanes = work[r * k:(r + 1) * k]
        assert torch.equal(lanes, torch.unique_consecutive(idx)), r
    assert work.shape[0] == sum(torch.unique_consecutive(i).shape[0] for i in plain)
    places = torch.arange(work.shape[0], dtype=torch.int32)
    assert torch.equal(slot[work.long()], torch.div(places, k, rounding_mode="floor"))
    assert int((slot >= 0).sum()) == work.shape[0]


def _card_stage(grid):
    """Cache columns of a first eval on the card and the next stage's inputs,
    with NaN and infinite lanes and invalid cache keys."""
    _, fs, name = _fieldsets(grid, "cuda")
    vf = getattr(fs.build_views(fs.device_arrays()), name)
    t, z, y, x, y2, x2 = (torch.as_tensor(a, device="cuda") for a in _stage_inputs(
        grid, fs.gridset[0]))
    y2[::97] = float("nan")
    x2[::89] = float("inf")
    n = y.shape[0]
    rng = np.random.default_rng(2)
    T, Z = vf.U.data.shape[:2]
    ti = torch.as_tensor(rng.integers(0, T - 1, n), dtype=torch.int32, device="cuda") \
        if T > 1 else torch.zeros(n, dtype=torch.int32, device="cuda")
    t1i = torch.clamp(ti + 1, 0, T - 1)
    zc = torch.as_tensor(rng.integers(0, Z, n), dtype=torch.int32, device="cuda")
    wzi = torch.clamp(zc, 0, max(Z - 2, 0))
    yi_g = torch.as_tensor(rng.integers(-2, 70, n), dtype=torch.int32, device="cuda")
    xi_g = torch.as_tensor(rng.integers(-2, 100, n), dtype=torch.int32, device="cuda")
    return vf, (y, x, y2, x2, ti, t1i, zc, wzi, yi_g, xi_g)


def _same(a, b):
    if a.is_floating_point():
        return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
            torch.nan_to_num(a), torch.nan_to_num(b))
    return torch.equal(a, b)


@pytest.mark.parametrize("grid", ["moi", "rotated"])
def test_cgrid_repair_kernel_matches_plain_on_card(grid):
    """K5 bit for bit against its plain version on every cache column,
    (xsi, eta) and the iteration counts: a first full eval (NaN and infinite
    lanes, warm cells off the grid), then a stage (``cgrid_stage``) of three
    rounds with invalid keys and a walking pad lane, whose counts and work
    list equal the plain loop's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    vf, (y, x, y2, x2, ti, t1i, zc, wzi, yi_g, xi_g) = _card_stage(grid)
    sph = vf.grid.spec.spherical
    args = (ti, t1i, zc, wzi)
    counts = [torch.zeros(2, dtype=torch.int64, device="cuda") for _ in range(4)]
    full = cgrid_repair.cgrid_full(vf, y2, x2, tis.query_xyz(y2, x2, sph), *args, yi_g, xi_g,
                                   iters=counts[0])
    want = cgrid_repair.cgrid_full_plain(vf, y2, x2, *args, yi_g, xi_g, iters=counts[1])
    for k in cgrid_repair.COLUMNS + ("xsi", "eta"):
        if want[k] is not None:
            assert _same(full[k], want[k]), k
    assert torch.equal(counts[0], counts[1])
    base = cgrid_repair.cgrid_full_plain(vf, y, x, *args, yi_g, xi_g)
    del base["xsi"], base["eta"]
    base.update(ti=ti.clone(), zi=zc.clone(), wzi=wzi.clone())
    base["cell"][::13] = -1  # invalid keys
    mask = torch.ones_like(y2, dtype=torch.bool)
    mask[1::4] = False
    mask[-1] = False  # a dead pad lane
    ck = {k: v.clone() if v is not None else None for k, v in base.items()}
    cp = {k: v.clone() if v is not None else None for k, v in base.items()}
    q = tis.query_xyz(y2, x2, sph)
    got = cgrid_repair.cgrid_stage(vf, ck, y2, x2, q, *args, mask, K, iters=counts[2])
    ref = cgrid_repair.cgrid_stage_plain(vf, cp, y2, x2, q, *args, mask, K, iters=counts[3])
    assert (int(got.cnt), int(got.rounds), int(got.length)) == (ref.cnt, ref.rounds, ref.length)
    assert ref.rounds == 3 and ref.length == ref.cnt + 1
    assert torch.equal(got.work[:ref.length], ref.work)
    assert _same(got.xsi, ref.xsi) and _same(got.eta, ref.eta)
    assert torch.equal(counts[2], counts[3])
    for k, v in cp.items():
        if v is not None:
            assert _same(ck[k], v), k
