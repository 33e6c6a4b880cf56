"""AdvectionAnalytical through the port against the JAX package.

``tests/test_advection.py``'s three analytical cases (the Stommel C-grid,
uniform flow on the C-grid peninsula, and the 3-D C-grid with W) run
through both packages: positions agree to 1e-4 of the domain extent with
equal states, and the JAX test's own asserts hold on the port.

On the peninsula the JAX package runs with jit disabled. Compiled, XLA
rounds the in-cell exponential of the first jump so that the lane stops
2.6e-5 of a cell short of the east face: past the kernel's 1e-5 face nudge,
so the next jump reaches only the face and spends the rest of the step
there (half the speed over 3 h). Operation by operation, as the port
computes, the jump lands on the face and the nudge carries the lane on.
"""

import jax
import numpy as np
import torch

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu import _sgrid as j_sgrid
from parcels_tpu import xrlite as j_xr
from parcels_tpu.datasets import peninsula_dataset as j_peninsula
from parcels_tpu.datasets import stommel_gyre_dataset as j_stommel
from parcels_tpu_torch import _sgrid as t_sgrid
from parcels_tpu_torch import xrlite as t_xr
from parcels_tpu_torch.datasets import peninsula_dataset as t_peninsula
from parcels_tpu_torch.datasets import stommel_gyre_dataset as t_stommel

# small tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

PORT = {"pkg": tp, "kw": {"device": "cpu"}, "stommel": t_stommel, "peninsula": t_peninsula,
        "sgrid": t_sgrid, "xr": t_xr}
JAX = {"pkg": jp, "kw": {}, "stommel": j_stommel, "peninsula": j_peninsula, "sgrid": j_sgrid,
       "xr": j_xr}


def SampleP(particles, fieldset):  # noqa: N802
    particles.p = fieldset.P[particles]


def _sample_p(which, fs, x0, y0):
    arr = torch.as_tensor if which is PORT else jax.numpy.asarray
    fsv = fs.build_views(fs.device_arrays())
    n = len(x0)
    z = np.zeros(n, np.float32)
    return np.asarray(fsv.P.eval(arr(z), arr(z), arr(np.asarray(y0, np.float32)),
                                 arr(np.asarray(x0, np.float32))))


def _compare(a, b, extent):
    for var in ("x", "y", "z"):
        np.testing.assert_allclose(getattr(a, var), getattr(b, var), rtol=0, atol=1e-4 * extent)
    np.testing.assert_array_equal(a.state, b.state)


def _stommel(which):
    pkg = which["pkg"]
    fs = pkg.FieldSet.from_sgrid_conventions(which["stommel"](grid_type="C"), mesh="flat",
                                             **which["kw"])
    pclass = pkg.Particle.add_variable(pkg.Variable("p", dtype=np.float32))
    x0, y0 = [3e6, 4e6, 5e6], [3e6, 5e6, 7e6]
    pset = pkg.ParticleSet(fs, pclass=pclass, x=x0, y=y0)
    pset.execute([pkg.AdvectionAnalytical, SampleP], dt=np.timedelta64(6, "h"),
                 runtime=np.timedelta64(2, "D"))
    return fs, pset, x0, y0


def test_analytical_advection_stommel_c_grid():
    fs, a, x0, y0 = _stommel(PORT)
    _, b, _, _ = _stommel(JAX)
    # the JAX test's asserts: the streamfunction is conserved and the
    # particles moved
    assert np.allclose(a.p, _sample_p(PORT, fs, x0, y0), rtol=2e-2)
    assert not np.allclose(a.x, x0, atol=1.0)
    _compare(a, b, extent=1e7)
    np.testing.assert_allclose(a.p, b.p, rtol=1e-4, atol=1e-4 * np.abs(b.p).max())


def _peninsula(which):
    pkg = which["pkg"]
    fs = pkg.FieldSet.from_sgrid_conventions(which["peninsula"](grid_type="C"), mesh="flat",
                                             **which["kw"])
    x0, y0 = np.full(3, 3e3), np.array([10e3, 25e3, 40e3])
    pset = pkg.ParticleSet(fs, x=x0, y=y0)
    pset.execute(pkg.AdvectionAnalytical, dt=np.timedelta64(30, "m"),
                 runtime=np.timedelta64(3, "h"))
    return pset, x0


def test_analytical_advection_uniform_flow_c_grid():
    a, x0 = _peninsula(PORT)
    with jax.disable_jit():
        b, _ = _peninsula(JAX)
    assert np.all(a.x > x0 + 1e3), a.x
    _compare(a, b, extent=1e5)


def _with_w(which, u0=0.05, w0=0.002):
    pkg, sgrid, xr = which["pkg"], which["sgrid"], which["xr"]
    xdim, ydim, nz = 30, 20, 6
    s = 1000.0
    shape = (2, nz, ydim, xdim)
    time = np.array([np.timedelta64(0, "s"), np.timedelta64(10, "D")])
    ds = xr.Dataset(
        {
            "U": (["time", "depth", "YG", "XC"], np.full(shape, u0, np.float32)),
            "V": (["time", "depth", "YC", "XG"], np.zeros(shape, np.float32)),
            "W": (["time", "depth", "YC", "XC"], np.full(shape, w0, np.float32)),
        },
        coords={
            "time": (["time"], time, {"axis": "T"}),
            "depth": (["depth"], np.linspace(0.0, 120.0, nz), {"axis": "Z"}),
            "YC": (["YC"], np.arange(ydim) - 0.5, {"axis": "Y"}),
            "YG": (["YG"], np.arange(ydim, dtype=np.float64), {"axis": "Y"}),
            "XC": (["XC"], np.arange(xdim) - 0.5, {"axis": "X"}),
            "XG": (["XG"], np.arange(xdim, dtype=np.float64), {"axis": "X"}),
            "lat": (["YG"], np.arange(ydim) * s, {"axis": "Y", "units": "m"}),
            "lon": (["XG"], np.arange(xdim) * s, {"axis": "X", "units": "m"}),
        },
    )
    meta = sgrid.SGrid2DMetadata(
        node_dimensions=("XG", "YG"),
        node_coordinates=("lon", "lat"),
        face_dimensions=(
            sgrid.FaceNodePadding("XC", "XG", sgrid.Padding.LOW),
            sgrid.FaceNodePadding("YC", "YG", sgrid.Padding.LOW),
        ),
        vertical_dimensions=(sgrid.FaceNodePadding("ZC", "depth", sgrid.Padding.BOTH),),
    )
    ds = sgrid.attach_sgrid_metadata(ds, meta)
    fs = pkg.FieldSet.from_sgrid_conventions(ds, mesh="flat", **which["kw"])
    pset = pkg.ParticleSet(fs, x=[2500.0], y=[9500.0], z=[10.0], t=[0.0])
    pset.execute(pkg.AdvectionAnalytical, dt=np.timedelta64(30, "m"),
                 runtime=np.timedelta64(6 * 3600, "s"))
    return pset


def test_analytical_advection_3d_with_w():
    u0, w0, runtime = 0.05, 0.002, 6 * 3600
    a, b = _with_w(PORT), _with_w(JAX)
    np.testing.assert_allclose(a.x, 2500.0 + u0 * runtime, rtol=1e-4)
    np.testing.assert_allclose(a.z, 10.0 + w0 * runtime, rtol=1e-3)
    np.testing.assert_allclose(a.y, 9500.0, atol=1.0)
    _compare(a, b, extent=3e4)
    # the engine reverted dt to the nominal step after every transit
    np.testing.assert_array_equal(a.dt, np.float32(1800.0))


# ---------------------------------------------------------------------------
# the f32 face stall (a deliberate difference: kernels/analytical.py
# _cross_stalled_faces)
# ---------------------------------------------------------------------------


def _counted_stommel(which, x0, y0, hours=48, dt_h=6):
    """AdvectionAnalytical on the Stommel gyre (2 days at dt 6 h unless
    told), with a count of the engine iterations each lane took."""
    pkg = which["pkg"]
    fs = pkg.FieldSet.from_sgrid_conventions(which["stommel"](grid_type="C"), mesh="flat",
                                             **which["kw"])
    pclass = pkg.Particle.add_variable(pkg.Variable("nit", dtype=np.float32))

    def Count(particles, fieldset):  # noqa: N802
        particles.nit = particles.nit + 1.0

    pset = pkg.ParticleSet(fs, pclass=pclass, x=x0, y=y0)
    pset.execute([pkg.AdvectionAnalytical, Count], dt=np.timedelta64(dt_h, "h"),
                 runtime=np.timedelta64(hours, "h"))
    return pset


#: one f32 step (0.25 m) north of the south face of its cell in the Stommel
#: gyre, where the flow runs south: the jump to the face rounds to the
#: lane's own position (a transit of 3.4 s). Random seeds reach this state
#: (seed 0's lane 167 after 1.7 days)
STALL_SEED = (np.array([7894390.0]), np.array([2512563.0]))


def test_analytical_lane_on_a_face_crosses_it(monkeypatch):
    """The lane finishes the 2 days in as many iterations as its neighbours;
    without the nudge it repeats its 3.4 s transit to the end, as the JAX
    package's eager scheme does: over one hour, about a thousand times."""
    from parcels_tpu_torch.kernels import analytical

    pset = _counted_stommel(PORT, *STALL_SEED)
    assert pset.nit[0] <= 20, pset.nit
    np.testing.assert_array_equal(pset.t, np.float32(2 * 86400))
    assert pset.y[0] < STALL_SEED[1][0] - 1e3  # it went on south
    fs = pset.fieldset
    p0, p1 = _sample_p(PORT, fs, *STALL_SEED), _sample_p(PORT, fs, pset.x, pset.y)
    np.testing.assert_allclose(p1, p0, rtol=2e-2)
    # the scheme as the JAX package has it: the lane stalls on the face
    monkeypatch.setattr(analytical, "_cross_stalled_faces", lambda new, *a: new)
    stalled = _counted_stommel(PORT, *STALL_SEED, hours=1, dt_h=1)
    assert stalled.nit[0] > 500, stalled.nit
    assert abs(stalled.y[0] - STALL_SEED[1][0]) <= 0.25  # at most one f32 step


def test_analytical_random_stommel_seeds_match_reference(monkeypatch):
    """Random seeds over the gyre: every lane finishes in a bounded number
    of iterations, and every lane the nudge never moved equals the JAX
    package (run eagerly, operation by operation as the port computes) at
    the file's tolerance, with equal states."""
    from parcels_tpu_torch.kernels import analytical

    nudged = []
    cross = analytical._cross_stalled_faces

    def crossed(new, *args):
        out = cross(new, *args)
        nudged.append(torch.stack([out[c] != new[c] for c in new]).any(dim=0))
        return out

    monkeypatch.setattr(analytical, "_cross_stalled_faces", crossed)
    rng = np.random.default_rng(0)
    x0, y0 = rng.uniform(1e6, 9e6, 200), rng.uniform(1e6, 9e6, 200)
    a = _counted_stommel(PORT, x0, y0)
    assert a.nit.max() <= 20, a.nit.max()
    moved = torch.stack(nudged).any(dim=0).numpy()[:len(x0)]  # the set is padded
    assert moved.sum() >= 1  # the grid reaches the stall (lane 167)
    keep = ~moved
    with jax.disable_jit():
        b = _counted_stommel(JAX, x0[keep], y0[keep])
    for var in ("x", "y"):
        np.testing.assert_allclose(getattr(a, var)[keep], getattr(b, var), rtol=0, atol=1e-4 * 1e7)
    np.testing.assert_array_equal(a.state[keep], b.state)
    assert b.nit.max() <= 20  # none of these lanes stalls in the JAX package either
