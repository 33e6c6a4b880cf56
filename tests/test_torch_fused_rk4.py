"""K3, the fused C-grid RK4 step, and its hit-and-repair stepper.

``fused_rk4_step_plain`` (the kernel's plain version, which the CPU runs) is
held to the JAX package's Pallas kernel (``scripts/bench_fused_rk4.py``'s
``make_kernel``) run in interpret mode, at 4096 lanes on rows of a MOi-shaped
grid: x/y within 2e-5 deg, miss flags equal except on tolerance-edge lanes
(a stage's (xsi, eta) within 1e-5 of -2e-4 or 1 + 2e-4, at most 0.1 % of
lanes). ``FusedRK4Stepper`` is held to the port's own engine on the CPU.
"""

import importlib
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import parcels_tpu_torch as tp
from parcels_tpu_torch._core import index_search as tis
from parcels_tpu_torch.datasets import moi_like_fieldset as t_moi
from parcels_tpu_torch.ops import fused_rk4, stagecache

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 4096
B = 2048
DT = 3600.0


@pytest.fixture(scope="module")
def bench():
    """scripts/bench_fused_rk4.py as a module. It sets
    PARCELS_TPU_STAGECACHE_K_DIV and sys.path at import: both are restored,
    and the JAX stage cache is imported first so it keeps its own K_DIV."""
    import parcels_tpu.ops.stagecache  # noqa: F401

    old_env = os.environ.get("PARCELS_TPU_STAGECACHE_K_DIV")
    old_path = list(sys.path)
    try:
        sys.path.insert(0, str(ROOT / "scripts"))
        return importlib.import_module("bench_fused_rk4")
    finally:
        sys.path[:] = old_path
        if old_env is None:
            os.environ.pop("PARCELS_TPU_STAGECACHE_K_DIV", None)
        else:
            os.environ["PARCELS_TPU_STAGECACHE_K_DIV"] = old_env


def _inputs(seed=0):
    """K3 planes on a MOi grid: points at random (xsi, eta) in [-0.02, 1.02]^2
    of random cells, random face values, NaN lanes and invalid rows."""
    fs = t_moi(xdim=120, ydim=80, zdim=2, seed=0, device="cpu")
    g = fs.gridset[0]
    tbl = stagecache._fused_table(fs.device_arrays()["grids"][0])
    rng = np.random.default_rng(seed)
    ny, nx = g.lon.shape
    yi, xi = rng.integers(0, ny - 1, N), rng.integers(0, nx - 1, N)
    a, b = rng.uniform(-0.02, 1.02, N), rng.uniform(-0.02, 1.02, N)

    def bilinear(arr):
        return ((1 - a) * (1 - b) * arr[yi, xi] + a * (1 - b) * arr[yi, xi + 1]
                + a * b * arr[yi + 1, xi + 1] + (1 - a) * b * arr[yi + 1, xi])

    x, y = bilinear(g.lon).astype(np.float32), bilinear(g.lat).astype(np.float32)
    x[::97] = np.nan
    rows = tbl[torch.as_tensor(yi * (nx - 1) + xi), :stagecache.ROW_COLS].numpy()
    valid = np.ones(N, np.float32)
    valid[::101] = 0.0
    rowsT = np.concatenate([rows.T, valid[None], np.zeros((6, N), np.float32)])
    uvT = rng.uniform(-0.3, 0.3, (8, N)).astype(np.float32)
    t0 = rng.uniform(0, 86400 - DT, N).astype(np.float32)
    z = np.zeros(N, np.float32)
    state = np.stack([x, y, t0, np.full(N, DT, np.float32), z, z, z, z])
    t1 = float(g.time[1])
    return fs, rowsT, uvT, state, (g.spec.deg2m, 1.0 / t1, DT)


def _stage_coords(rowsT, uvT, state, args):
    """Each stage's (xsi, eta) at the plain version's stage positions."""
    deg2m, inv_t1, dt = (fused_rk4._f32(v) for v in args)
    r, uv = torch.as_tensor(rowsT), torch.as_tensor(uvT)
    x, y, t = (torch.as_tensor(state[k]) for k in range(3))
    rows = r[:16].t()
    coords, pos = [], (x, y, t)
    for k, f in enumerate((0.5, 0.5, 1.0, None)):
        xs, ys, ts = pos
        _, xsi, eta = tis.pic_from_rows(rows, tis.query_xyz(ys, xs, True))
        coords.append((xsi.numpy(), eta.numpy()))
        if f is not None:
            u, v, _ = fused_rk4._stage_plain(r, uv, xs, ys, ts, deg2m, inv_t1)
            pos = (x + f * dt * u, y + f * dt * v, t + f * dt)
    return coords


def test_plain_matches_pallas_interpret(bench):
    fs, rowsT, uvT, state, args = _inputs()
    kern = bench.make_kernel(*args)
    spec2 = lambda rows: pl.BlockSpec((rows, B), lambda i: (0, i))  # noqa: E731
    ref = np.asarray(pl.pallas_call(
        kern, grid=(N // B,), in_specs=[spec2(32), spec2(8), spec2(8)], out_specs=spec2(8),
        out_shape=jax.ShapeDtypeStruct((8, N), jnp.float32), interpret=True,
    )(jnp.asarray(rowsT), jnp.asarray(uvT), jnp.asarray(state)))
    got = fused_rk4.fused_rk4_step(*(torch.as_tensor(a) for a in (rowsT, uvT, state)),
                                   *args).numpy()
    np.testing.assert_array_equal(np.isnan(got[:2]), np.isnan(ref[:2]))
    np.testing.assert_allclose(got[:2], ref[:2], rtol=0, atol=2e-5, equal_nan=True)
    np.testing.assert_array_equal(got[2:4], ref[2:4])
    edge = np.zeros(N, bool)
    for xsi, eta in _stage_coords(rowsT, uvT, state, args):
        for v in (xsi, eta):
            edge |= (np.abs(v + 2e-4) <= 1e-5) | (np.abs(v - (1 + 2e-4)) <= 1e-5)
    assert edge.sum() <= 1e-3 * N
    differ = got[4] != ref[4]
    assert not (differ & ~edge).any(), np.nonzero(differ & ~edge)
    # the inputs reach hits, misses, NaN lanes and invalid rows
    assert 0.05 < ref[4].mean() < 0.9
    assert (got[4][::101] == 1).all() and (got[4][::97] == 1).all()


def test_plain_step_on_a_row_is_the_stage_cache_blend():
    """On a lane that stays in its cell, K3's step equals an RK4 step through
    the stage cache's pic + blend (the engine's operands) to f32 rounding."""
    fs, rowsT, uvT, state, args = _inputs(seed=1)
    out = fused_rk4.fused_rk4_step_plain(*(torch.as_tensor(a) for a in (rowsT, uvT, state)),
                                         *args)
    hit = (out[4] == 0).numpy()
    vf = fs.build_views(fs.device_arrays()).UV
    row = torch.as_tensor(rowsT[:stagecache.ROW_COLS].T.copy())
    u4, v4 = torch.as_tensor(uvT[:4].T.copy()), torch.as_tensor(uvT[4:].T.copy())
    x, y, t = (torch.as_tensor(state[k]) for k in range(3))
    inv_t1, dt = args[1], args[2]

    def uv(xs, ys, ts):
        _, xsi, eta = tis.pic_from_rows(row, tis.query_xyz(ys, xs, True))
        tau = torch.clamp(ts * inv_t1, 0.0, 1.0)
        u, v, _ = stagecache._blend(vf.grid.spec, row, xsi, eta, tau, None, u4, v4, None, 1, ys)
        return u, v

    u1, v1 = uv(x, y, t)
    u2, v2 = uv(x + 0.5 * dt * u1, y + 0.5 * dt * v1, t + 0.5 * dt)
    u3, v3 = uv(x + 0.5 * dt * u2, y + 0.5 * dt * v2, t + 0.5 * dt)
    u4_, v4_ = uv(x + dt * u3, y + dt * v3, t + dt)
    xn = x + (u1 + 2 * u2 + 2 * u3 + u4_) / 6.0 * dt
    yn = y + (v1 + 2 * v2 + 2 * v3 + v4_) / 6.0 * dt
    assert hit.mean() > 0.5
    np.testing.assert_allclose(out[0].numpy()[hit], xn.numpy()[hit], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out[1].numpy()[hit], yn.numpy()[hit], rtol=0, atol=1e-5)


def _warm_batch(monkeypatch, n, **kw):
    """A MOi fieldset and a ParticleSet after one engine step with the stage
    cache forced (its SoA columns filled)."""
    monkeypatch.setenv("PARCELS_TPU_STAGECACHE", "force")
    fs = t_moi(xdim=120, ydim=80, zdim=2, seed=0, device="cpu", **kw)
    rng = np.random.default_rng(2)
    x, y = rng.uniform(-170, 170, n), rng.uniform(-60, 70, n)
    pset = tp.ParticleSet(fs, x=x, y=y, z=np.full(n, 1.0), t=np.zeros(n))
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(int(DT), "s"),
                 runtime=np.timedelta64(int(DT), "s"))
    return fs, pset


@pytest.mark.parametrize("repair", [True, False])
def test_stepper_matches_engine(monkeypatch, repair):
    """The hit-and-repair stepper against the port's engine advancing the
    same warm batch: within 1e-4 deg on at least 99 % of the lanes and under
    0.08 deg on all (the last lane is live, so a pad scattered onto it would
    show). Without the repair, misses advance with stale cells."""
    n = N
    fs, pset = _warm_batch(monkeypatch, n)
    warm = dict(pset._data)
    stepper = fused_rk4.FusedRK4Stepper(fs, warm, DT, repair=repair)
    assert stepper.kcap == 8192 and stepper.n == n
    steps = 4
    launches = fused_rk4.fused_rk4_step.launches
    counts = [int(stepper.one_step()) for _ in range(steps)]
    assert fused_rk4.fused_rk4_step.launches == launches  # the CPU runs the plain version
    assert max(counts) <= stepper.kcap and sum(counts) > 0
    pset.execute(tp.AdvectionRK4, dt=np.timedelta64(int(DT), "s"),
                 runtime=np.timedelta64(int(DT) * steps, "s"))
    d = np.maximum(np.abs(stepper.state[0].numpy() - pset.x),
                   np.abs(stepper.state[1].numpy() - pset.y))
    np.testing.assert_array_equal(stepper.state[2].numpy(), pset.t)
    if repair:
        assert (d > 1e-4).mean() <= 0.01 and d.max() < 0.08
    else:
        assert np.isfinite(d).all() and (d > 1e-4).any()


@pytest.mark.parametrize("last_lane", ["repaired", "not repaired"])
def test_scatter_sub_leaves_pads_out(monkeypatch, last_lane):
    """The scatter clamps pad lanes (idx == n) to lane n - 1 with no host
    read: the planes equal a scatter of the real lanes alone, whether lane
    n - 1 is itself repaired (its pads carry its own values) or not (they
    carry its current planes)."""
    n = 512
    fs, pset = _warm_batch(monkeypatch, n)
    monkeypatch.setattr(fused_rk4, "KCAP_MIN", 64)
    stepper = fused_rk4.FusedRK4Stepper(fs, dict(pset._data), DT)
    out = fused_rk4.fused_rk4_step(stepper.rowsT, stepper.uvT, stepper.state, stepper.deg2m,
                                   stepper.inv_t1, stepper.dt)
    miss = torch.zeros(n)
    miss[5:400:7] = 1.0
    miss[n - 1] = 1.0 if last_lane == "repaired" else 0.0
    idx = stepper.round_idx(miss)
    assert int((idx == n).sum()) > 0 and bool((idx == n - 1).any()) == (last_lane == "repaired")
    sub_out = stepper.repair_rk4(stepper.gather_sub(stepper.state, idx), float(stepper.t))

    keep = idx < n  # the boolean-mask scatter this replaces, as a reference
    want_out, want_rows, want_uv = out.clone(), stepper.rowsT.clone(), stepper.uvT.clone()
    want_cell = stepper.cell.clone()
    il = idx[keep]
    z = torch.zeros(il.shape[0])
    want_out[:, il] = torch.stack([sub_out["x"][keep], sub_out["y"][keep], sub_out["t"][keep],
                                   sub_out["dt"][keep], z, z, z, z])
    want_cell[il] = sub_out["cell"][keep]
    want_rows[:, il] = stepper._rows_planes(sub_out["cell"][keep])
    want_uv[:, il] = torch.cat([sub_out["u4"][keep].t(), sub_out["v4"][keep].t()])

    got = stepper.scatter_sub(out.clone(), stepper.rowsT, stepper.uvT, idx, sub_out)
    for g, w in zip(got, (want_out, want_rows, want_uv)):
        assert torch.equal(g, w)
    assert torch.equal(stepper.cell, want_cell)


def test_stepper_checks_its_assumptions(monkeypatch):
    fs, pset = _warm_batch(monkeypatch, 16, tdim=3)
    with pytest.raises(ValueError, match="2-level time axis"):
        fused_rk4.FusedRK4Stepper(fs, dict(pset._data), DT)
    monkeypatch.setenv("PARCELS_TPU_STAGECACHE", "off")
    fs = t_moi(xdim=120, ydim=80, zdim=2, seed=0, device="cpu")
    pset = tp.ParticleSet(fs, x=[0.0], y=[0.0], t=[0.0])
    with pytest.raises(ValueError, match="stage-cache columns"):
        fused_rk4.FusedRK4Stepper(fs, dict(pset._data), DT)


def test_stepper_raises_on_repair_overflow(monkeypatch):
    """A step with more misses than the repair round holds leaves lanes on
    K3's answer from cells they left: reading the state raises."""
    fs, pset = _warm_batch(monkeypatch, N)
    monkeypatch.setattr(fused_rk4, "KCAP_DIV", N)
    monkeypatch.setattr(fused_rk4, "KCAP_MIN", 1)
    stepper = fused_rk4.FusedRK4Stepper(fs, dict(pset._data), DT)
    assert stepper.kcap == 1
    cnt = int(stepper.one_step())
    assert cnt > stepper.kcap
    with pytest.raises(RuntimeError, match="repair round overflow"):
        stepper.state
    # without the repair nothing is dropped, so nothing is audited
    stepper = fused_rk4.FusedRK4Stepper(fs, dict(pset._data), DT, repair=False)
    stepper.one_step()
    assert stepper.state.shape == (8, N)


def _script_repair_rk4(fs, sub, t0, dt):
    """The JAX path's ``repair_rk4`` (``scripts/bench_fused_rk4.py:286-331``,
    a closure of its ``main``), line for line on the JAX package."""
    from parcels_tpu._core import index_search
    from parcels_tpu.ops.stagecache import _blend, _full

    vf_t = fs.build_views(fs.device_arrays()).UV
    spec = vf_t.grid.spec
    t1 = float(np.asarray(vf_t.grid.garrs["time"])[1])
    inv_t1 = np.float32(1.0 / t1)
    cy_g, cx_g = max(spec.ydim, 1), max(spec.xdim, 1)
    x0, y0 = sub["x"], sub["y"]
    K = x0.shape[0]
    ti = jnp.zeros(K, jnp.int32)
    t1i = jnp.ones(K, jnp.int32)
    zc = jnp.zeros(K, jnp.int32)
    zeta = jnp.zeros(K, jnp.float32)
    ei0 = sub["ei"]
    yi_g = (ei0 // cx_g) % cy_g
    xi_g = ei0 % cx_g

    def sample(xs, ys, ts, yi_w, xi_w):
        c = _full(vf_t, ys, xs, ti, t1i, zc, zc, yi_w, xi_w)
        q = index_search.query_xyz(ys, xs, spec.spherical)
        _, xsi, eta = index_search.pic_from_rows(c["row"], q)
        tau = jnp.clip(ts * inv_t1, 0.0, 1.0)
        u, v, _w = _blend(spec, c["row"], xsi, eta, tau, zeta, c["u4"], c["v4"], None, 1, ys)
        return u, v, c

    dtf = jnp.float32(dt)
    t0s = jnp.float32(t0)
    u1, v1, c1 = sample(x0, y0, t0s, yi_g, xi_g)
    u2, v2, c2 = sample(x0 + 0.5 * dtf * u1, y0 + 0.5 * dtf * v1, t0s + 0.5 * dtf,
                        c1["yi"], c1["xi"])
    u3, v3, c3 = sample(x0 + 0.5 * dtf * u2, y0 + 0.5 * dtf * v2, t0s + 0.5 * dtf,
                        c2["yi"], c2["xi"])
    u4, v4, c4 = sample(x0 + dtf * u3, y0 + dtf * v3, t0s + dtf, c3["yi"], c3["xi"])
    xn = x0 + (u1 + 2 * u2 + 2 * u3 + u4) / 6.0 * dtf
    yn = y0 + (v1 + 2 * v2 + 2 * v3 + v4) / 6.0 * dtf
    return {"x": xn, "y": yn, "cell": c4["cell"], "u4": c4["u4"], "v4": c4["v4"]}


def test_repair_matches_script_repair(monkeypatch):
    """The stepper's repair against the JAX path's on the same compacted
    sub-batch (one step's K3 misses) and the same warm-start cells: x/y
    within 2e-5 deg, the same final cells and face values. The stepper
    warm-starts from each lane's cached cell where the JAX path passes the
    warm batch's element index; both are handed the cached cell here."""
    from parcels_tpu.datasets import moi_like_fieldset as j_moi

    fs, pset = _warm_batch(monkeypatch, N)
    stepper = fused_rk4.FusedRK4Stepper(fs, dict(pset._data), DT)
    out = fused_rk4.fused_rk4_step(stepper.rowsT, stepper.uvT, stepper.state, stepper.deg2m,
                                   stepper.inv_t1, stepper.dt)
    idx = stepper.round_idx(out[4])
    sub = stepper.gather_sub(stepper.state, idx)
    live = sub["_active"].numpy()
    assert 0 < live.sum() < N
    t0 = float(stepper.t)
    got = stepper.repair_rk4(sub, t0)
    jsub = {"x": jnp.asarray(sub["x"].numpy()), "y": jnp.asarray(sub["y"].numpy()),
            "ei": jnp.asarray(torch.clamp_min(sub["cell"], 0).numpy())}
    ref = _script_repair_rk4(j_moi(xdim=120, ydim=80, zdim=2, seed=0), jsub, t0, DT)
    for k in ("x", "y"):
        np.testing.assert_allclose(got[k].numpy()[live], np.asarray(ref[k])[live],
                                   rtol=0, atol=2e-5)
    for k in ("cell", "u4", "v4"):
        np.testing.assert_array_equal(got[k].numpy()[live], np.asarray(ref[k])[live])


def test_kernel_matches_plain_on_card():
    """K3 bit for bit against its plain version, NaN lanes and invalid rows
    included, with full and ragged last blocks of 256 threads, and with face
    values that send lanes to its exact redo (tiny, and zero on every 7th
    lane)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, rowsT, uvT, state, args = _inputs()
    tiny = uvT * np.float32(2.0**-80)
    land = uvT.copy()
    land[:, ::7] = 0.0
    for n, uv in ((N, uvT), (1380, uvT), (259, uvT), (1, uvT), (N, tiny), (N, land)):
        planes = [torch.as_tensor(np.ascontiguousarray(a[:, :n]), device="cuda")
                  for a in (rowsT, uv, state)]
        got = fused_rk4.fused_rk4_step(*planes, *args)
        torch.cuda.synchronize()
        want = fused_rk4.fused_rk4_step_plain(*planes, *args)
        assert torch.equal(torch.isnan(got), torch.isnan(want)), n
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)), n
