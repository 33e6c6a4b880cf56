"""ParticleSet: particle SoA owner + simulation entry point (torch).

Port of the single-device path of the JAX package's
``_core/particleset.py``. The SoA is a dict of tensors on the fieldset's
device. ``execute`` drives the engine (``engine.run_chunk``) one
output-interval chunk at a time, streams trajectory snapshots to the
ParticleFile writer, and raises the reference's typed exceptions if any
particle ends a chunk in an error state. Under ``FieldSet.set_time_window``
each chunk is clamped to what one window covers, and the next window is
prefetched while the chunk runs. ``checkpoint``/``from_checkpoint`` save
and restore the whole SoA; ``from_particlefile`` restarts from a written
trajectory file. ``pset += other`` merges a second release on the set's
device, ``remove_indices`` recaptures particles, and iteration, indexing
and ``describe`` copy each column to the host once per call.

Bound to a ``parallel`` particle mesh, band or tile domain
(``shard_particleset``), ``execute`` runs over the ranks of the process
group: each rank runs its lanes, the rank-sharded output writes one file a
rank, and the SoA is gathered back to every rank at the end. The lockstep
time window of the JAX package is not ported (the card's K1 samples the
whole field, see ``ops/interp_kernels``).
"""

from __future__ import annotations

import os
import time as _time
import types
import warnings

import numpy as np
import torch

from parcels_tpu_torch._core.engine import DEFAULT_BLOCK_SIZE, _sort_mode_enabled, run_chunk
from parcels_tpu_torch._core.particle import Particle, create_particle_data
from parcels_tpu_torch._core.statuscodes import (
    MIN_ERROR_CODE,
    StatusCode,
    raise_error_from_state,
)
from parcels_tpu_torch._core.timeutils import timedelta_to_float
from parcels_tpu_torch._core.warnings_ import KernelWarning, ParticleSetWarning

__all__ = ["ParticleSet", "state_from_numpy"]

#: SoA columns of the engine's persistent caches, which are no particle variables
_CACHE_PREFIXES = ("_sc_", "_uxc_")


def padded_capacity(n: int, block_size: int = DEFAULT_BLOCK_SIZE) -> int:
    """The lane count ``execute`` pads ``n`` particles to: the next power of
    two (>= 8) below 8192, multiples of 8192 beyond, then multiples of
    ``block_size``."""
    if n < 8192:
        target = 8
        while target < n:
            target *= 2
    else:
        target = -(-n // 8192) * 8192
    if target > block_size and target % block_size:
        target = -(-target // block_size) * block_size
    return target


def soa_bytes(fieldset, particles: int, pclass=Particle) -> int:
    """Device bytes of the SoA of ``particles`` particles of ``pclass`` on
    ``fieldset`` once ``execute`` has padded it: every column (the host-side
    RNG key aside), with the persistent cache columns where they apply."""
    if particles <= 0:
        return 0
    from parcels_tpu_torch.ops import stagecache, uxcache

    row = create_particle_data(pclass=pclass, nparticles=1, ngrids=len(fieldset.gridset))
    cols = [v for k, v in row.items() if k != "_rng"]
    sc_ok, sc_w = stagecache.soa_cache_applicable(fieldset)
    if sc_ok:
        cols += list(stagecache.make_soa_cache(1, sc_w, "cpu").values())
    uxc_ok, uxc_meta = uxcache.soa_cache_applicable(fieldset)
    if uxc_ok:
        cols += list(uxcache.make_soa_cache(1, uxc_meta, "cpu").values())
    return padded_capacity(particles) * sum(int(c.nbytes) for c in cols)


def _cache_fill(key: str, n: int, like: torch.Tensor) -> torch.Tensor:
    """Fresh (invalid) entries of a persistent cache column for ``n`` lanes:
    -1 keys, 0 values."""
    return torch.full((n,) + tuple(like.shape[1:]), -1 if key.endswith("_key") else 0,
                      dtype=like.dtype, device=like.device)


def _to_device(arr, device) -> torch.Tensor:
    """A device tensor holding a copy of ``arr``, dtype unchanged."""
    return torch.as_tensor(np.array(arr, copy=True), device=device)


def state_from_numpy(field_arrays: dict, pdata: dict, device):
    """The port's field tensors and SoA from the JAX package's numpy state.

    ``field_arrays`` is ``{"fields": {name: array}, "grids": [{coord:
    array}]}`` as ``FieldSet.device_arrays()`` holds it, for structured
    grids and for a ``UxGrid`` alike (its (T, Z, N) fields, mesh tables and
    fused face table, whose ids keep their bit patterns); ``pdata`` is a
    ``ParticleSet._data`` dict, with the persistent cache columns
    (``_sc_*``, ``_uxc_*``) where it has them. Every array keeps its dtype
    (f32 positions and ``_tc`` carry, int32 ``state``/``ei``/cache keys,
    bool ``_active``); the ``_rng`` key stays on the host, as the port
    keeps it.
    """
    device = torch.device(device)
    farrays = {
        "fields": {k: _to_device(v, device) for k, v in field_arrays["fields"].items()},
        "grids": [{k: _to_device(v, device) for k, v in g.items()} for g in field_arrays["grids"]],
    }
    return farrays, {k: _to_device(v, "cpu" if k == "_rng" else device)
                     for k, v in pdata.items()}


def _host(v: torch.Tensor) -> np.ndarray:
    return v.detach().cpu().numpy()


class ParticleSet:
    """Fixed-capacity particle container bound to a FieldSet (on its device)."""

    def __init__(self, fieldset, pclass=Particle, t=None, z=None, y=None, x=None,
                 particle_ids=None, seed: int = 0, **kwargs):
        self.fieldset = fieldset
        self._pclass = pclass

        y = np.empty(0) if y is None else np.asarray(y, dtype=np.float64).flatten()
        x = np.empty(0) if x is None else np.asarray(x, dtype=np.float64).flatten()
        if particle_ids is None:
            particle_ids = np.arange(x.size)
        else:
            particle_ids = np.asarray(particle_ids).flatten()
        if z is None:
            # default z: the shallowest depth level across all grids
            minz = None
            for grid in fieldset.gridset:
                for depth in np.atleast_1d(grid.depth):
                    if minz is None or abs(depth) < abs(minz):
                        minz = depth
            z = np.full(x.size, minz if minz is not None else 0.0)
        else:
            z = np.asarray(z, dtype=np.float64).flatten()
        if not x.size == y.size == z.size:
            raise ValueError("x, y, z don't all have the same lengths")
        t = self._normalize_release_times(t, x.size)
        if x.size != t.size:
            raise ValueError("t and positions (x, y, z) do not have the same lengths.")

        data = create_particle_data(
            pclass=pclass,
            nparticles=x.size,
            ngrids=len(fieldset.gridset),
            initial=dict(t=t, z=z, y=y, x=x, particle_id=particle_ids),
            seed=seed,
        )
        var_names = pclass.var_names()
        for kwvar, kwval in kwargs.items():
            kwval = np.asarray(kwval).flatten()
            if kwval.size != x.size:
                raise ValueError(f"{kwvar} and positions (x, y, z) don't have the same lengths.")
            if kwvar not in var_names:
                raise RuntimeError(f"Particle class does not have Variable {kwvar}")
            data[kwvar][:] = kwval.astype(data[kwvar].dtype)
        # the RNG key stays on the host: a draw splits it without a device read
        self._data = {k: _to_device(v, "cpu" if k == "_rng" else self.device)
                      for k, v in data.items()}

    @property
    def device(self) -> torch.device:
        return self.fieldset.device

    def _normalize_release_times(self, t, n: int) -> np.ndarray:
        if t is None or (hasattr(t, "__len__") and len(t) == 0):
            return np.full(n, np.nan)
        t = np.atleast_1d(np.asarray(t)).flatten()
        if np.issubdtype(t.dtype, np.datetime64):
            if self.fieldset.time_interval is None:
                raise ValueError("Cannot use datetime release times without a fieldset time interval.")
            t = timedelta_to_float(t - np.datetime64(self.fieldset.time_interval.left, "ns"))
        elif np.issubdtype(t.dtype, np.timedelta64):
            t = timedelta_to_float(t)
        else:
            t = t.astype(np.float64)
        if t.size == 1:
            t = np.repeat(t, n)
        if self.fieldset.time_interval is not None:
            _warn_release_outside_bounds(t, self.fieldset.time_interval)
        return t

    # -- container protocol --------------------------------------------------
    def __len__(self):
        return int(self._data["_active"].sum())

    @property
    def size(self):
        return len(self)

    def _host_columns(self) -> dict:
        """Every particle column as numpy, each copied from the device once
        (the RNG key and the persistent cache columns left out)."""
        return {k: _host(v) for k, v in self._data.items()
                if k != "_rng" and not k.startswith(_CACHE_PREFIXES)}

    def _summary(self, host: dict) -> str:
        act = host["_active"]
        n = int(act.sum())
        uniq = dict(zip(*np.unique(host["state"][act], return_counts=True))) if n else {}
        return (
            f"ParticleSet(n={n}, pclass={getattr(self._pclass, '__name__', self._pclass)!r}, "
            f"states={ {int(k): int(v) for k, v in uniq.items()} }, device={self.device})"
        )

    def __repr__(self):
        return self._summary({k: _host(self._data[k]) for k in ("_active", "state")})

    def _repr_sections(self):
        """Sectioned repr (reference particleset_repr, _repr_utils.py:91-105)."""
        host = self._host_columns()
        act = host["_active"]
        bounds = []
        for k in ("x", "y", "z", "t"):
            v = host[k][act]
            if v.size:
                bounds.append(f"{k}: min={v.min():.6g} max={v.max():.6g}")
        n = int(act.sum())
        sample = [repr(_ParticleRecord(host, int(i))) for i in np.flatnonzero(act)[:7]]
        if n > len(sample):
            sample.append(f"... ({n - len(sample)} more)")
        sections = [("summary", [self._summary(host)]), ("bounds", bounds), ("particles", sample)]
        stats = getattr(self, "last_run_stats", None)
        if stats:
            sections.append(("last run", [f"{k}: {v}" for k, v in stats.items()]))
        return sections

    def describe(self, buf=None) -> None:
        from parcels_tpu_torch._repr import write_sections

        write_sections(type(self).__name__, self._repr_sections(), buf)

    def _repr_html_(self):
        from parcels_tpu_torch._repr import html_sections

        return html_sections(type(self).__name__, self._repr_sections())

    def add(self, other: "ParticleSet") -> "ParticleSet":
        """Merge ``other``'s particles into this set in place (reference
        ParticleSet.add / ``pset += other``), on this set's device.

        Inactive lanes of both sets (deleted, removed, capacity padding) are
        dropped. The engine's persistent cache columns (``_sc_*``,
        ``_uxc_*``) are injected by ``execute``, so a set that has not run
        lacks them: they are no particle variables, and the side without
        them gets fresh invalid entries (keys -1, values 0). This set keeps
        its RNG key. Sets on two devices raise ValueError.
        """
        if not isinstance(other, ParticleSet):
            raise TypeError(f"Can only add another ParticleSet, got {type(other)}")
        if other.device != self.device:
            raise ValueError(
                f"Cannot add a ParticleSet on {other.device} to one on {self.device}."
            )

        def _vars(d):
            return {k for k in d if not k.startswith(_CACHE_PREFIXES)}

        if _vars(self._data) != _vars(other._data):
            raise ValueError("ParticleSets have different particle variables.")
        a1, a2 = self._data["_active"], other._data["_active"]
        n1, n2 = int(a1.sum()), int(a2.sum())
        merged = {}
        for k in list(self._data) + [k for k in other._data if k not in self._data]:
            if k == "_rng":
                merged[k] = self._data[k]
                continue
            v1 = self._data[k][a1] if k in self._data else _cache_fill(k, n1, other._data[k])
            v2 = other._data[k][a2] if k in other._data else _cache_fill(k, n2, self._data[k])
            merged[k] = torch.cat([v1, v2])
        self._data = merged
        return self

    def __iadd__(self, other):
        return self.add(other)

    def __iter__(self):
        """Iterate over active particles as read-only records; each column
        crosses to the host once per call."""
        host = self._host_columns()
        for i in np.flatnonzero(host["_active"]):
            yield _ParticleRecord(host, int(i))

    def __getitem__(self, index):
        """A single ACTIVE particle by index (reference particleset.py:165).

        Indexing is active-relative, as ``__iter__``, ``remove_indices`` and
        ``data_indices`` are: padding and deleted lanes are not addressable.
        Each column crosses to the host once.
        """
        host = self._host_columns()
        return _ParticleRecord(host, int(np.flatnonzero(host["_active"])[int(index)]))

    def set_variable_write_status(self, var: str, write_status: bool):
        """Set whether ``var`` is written to trajectory output
        (reference particleset.py:342-352)."""
        names = [v.name for v in self._pclass.variables]
        if var not in names:
            raise ValueError(f"Particle class has no variable {var!r}")
        if write_status not in (True, False):
            raise ValueError(f"write_status must be True or False. Got {write_status!r}")
        from parcels_tpu_torch._core.particle import ParticleClass, Variable

        def toggled(v):
            nv = Variable(v.name, v.dtype, v.initial, write_status, None)
            # keep CF attrs through a disable/enable cycle (the constructor
            # forbids attrs on non-written vars, but they must survive)
            nv.attrs = dict(v.attrs)
            return nv

        self._pclass = ParticleClass(
            [toggled(v) if v.name == var else v for v in self._pclass.variables]
        )

    def remove_indices(self, indices):
        """Deactivate the particles at the given active-relative indices."""
        idx = np.asarray(indices)
        if idx.dtype != bool:
            idx = idx.astype(np.int64)
        active = self._data["_active"]
        rows = torch.nonzero(active).flatten()[torch.as_tensor(idx, device=self.device)]
        mask = active.clone()
        mask[rows] = False
        self._data["_active"] = mask

    def data_indices(self, variable_name, compare_values, invert=False):
        """Active-relative indices of the particles whose ``variable_name``
        is (``invert``: is not) one of ``compare_values``."""
        compare_values = np.atleast_1d(compare_values)
        vals = self.__getattr__(variable_name)
        return np.where(np.isin(vals, compare_values, invert=invert))[0]

    @property
    def _error_particles(self):
        return self.data_indices("state", [StatusCode.Success, StatusCode.Evaluate], invert=True)

    @property
    def _num_error_particles(self):
        return int(
            np.sum(np.isin(self.state, [StatusCode.Success, StatusCode.Evaluate], invert=True))
        )

    def __getattr__(self, name):
        """Active lanes of a particle variable, as numpy. The engine's
        persistent-cache columns (``_sc_*``, ``_uxc_*``) are not particle
        variables."""
        data = self.__dict__.get("_data")
        if data is not None and name in data and not name.startswith(_CACHE_PREFIXES):
            arr = _host(data[name])
            active = _host(data["_active"])
            if arr.ndim >= 1 and arr.shape[0] == active.shape[0]:
                return arr[active]
            return arr
        raise AttributeError(f"ParticleSet has no attribute {name!r}")

    def __setattr__(self, name, value):
        data = self.__dict__.get("_data")
        if data is not None and name in data:
            arr = data[name].clone()
            value = torch.as_tensor(np.asarray(value), device=arr.device).to(arr.dtype)
            arr[data["_active"]] = value
            data[name] = arr
            return
        object.__setattr__(self, name, value)

    @property
    def state(self):
        return self.__getattr__("state")

    def populate_indices(self):
        """Pre-populate the cached element indices (warm start and sort keys)."""
        garrs = self.fieldset._grid_arrays()
        ei = self._data["ei"].clone()
        for i, grid in enumerate(self.fieldset.gridset):
            gpos = grid.make_view(garrs[i]).search(
                self._data["z"], self._data["y"], self._data["x"]
            )
            if "FACE" in gpos:
                ei[:, i] = torch.clamp(gpos["FACE"]["index"], 0, grid.n_face - 1).to(ei.dtype)
                continue
            zi = torch.clamp(gpos["Z"]["index"], 0, max(grid.zdim - 1, 0))
            yi = torch.clamp(gpos["Y"]["index"], 0, max(grid.ydim - 1, 0))
            xi = torch.clamp(gpos["X"]["index"], 0, max(grid.xdim - 1, 0))
            ei[:, i] = grid.ravel_index(zi, yi, xi).to(ei.dtype)
        self._data["ei"] = ei

    # -- checkpoint / restart ------------------------------------------------
    def checkpoint(self, path: str):
        """Write the full particle state to an .npz checkpoint: every SoA
        column, including non-written variables, the validity mask, the
        (2,) uint32 RNG key ``_rng``, the clock carry ``_tc`` and the
        persistent cache columns (``_sc_*``, ``_uxc_*``). The file is
        written beside ``path`` and renamed into place, so that the ranks of
        a multi-rank run, which hold the same gathered state, may all write
        it."""
        import tempfile

        path = os.fspath(path)
        if not path.endswith(".npz"):
            path += ".npz"  # as numpy.savez_compressed names it
        fd, tmp = tempfile.mkstemp(suffix=".npz", dir=os.path.dirname(os.path.abspath(path)))
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez_compressed(fh, **{k: _host(v) for k, v in self._data.items()})
            os.replace(tmp, path)
        except BaseException:
            os.unlink(tmp)
            raise

    @classmethod
    def from_checkpoint(cls, fieldset, path: str, pclass=Particle):
        """Restore a ParticleSet exactly as checkpointed (ids, states, RNG
        key, caches), on ``fieldset``'s device. Reads the JAX package's
        checkpoints too."""
        with np.load(path) as npz:
            data = {k: npz[k] for k in npz.files}
        if "_tc" not in data:  # checkpoints written before the Kahan clock
            data["_tc"] = np.zeros_like(np.asarray(data["t"]), dtype=np.float32)
        pset = cls.__new__(cls)
        pset.fieldset = fieldset
        pset._pclass = pclass
        pset._data = {k: _to_device(v, "cpu" if k == "_rng" else fieldset.device)
                      for k, v in data.items()}
        return pset

    @classmethod
    def from_particlefile(cls, fieldset, pclass, filename, restart=True, restarttime=None,
                          **kwargs):
        """Restart a ParticleSet from a written trajectory file: the last (or
        requested) output time of each trajectory seeds the particles,
        keeping their ids when ``restart=True``."""
        from parcels_tpu_torch._core.particlefile import read_particlefile

        df = read_particlefile(filename, decode_times=False)
        if restarttime is None:
            restarttime = df["t"].max()
        elif callable(restarttime):
            restarttime = restarttime(df["t"].values)
        sel = df[df["t"] == restarttime]
        return cls(
            fieldset=fieldset,
            pclass=pclass,
            t=sel["t"].values.astype(np.float64),
            z=sel["z"].values if "z" in sel else None,
            y=sel["y"].values,
            x=sel["x"].values,
            particle_ids=sel["particle_id"].values if restart else None,
            **kwargs,
        )

    # -- execution -----------------------------------------------------------
    def execute(self, kernels, dt, endtime=None, runtime=None, output_file=None,
                verbose_progress: bool = False, options=None):
        """Run the kernel chain over the particle set until endtime/runtime.

        Mirrors reference ParticleSet.execute (particleset.py:354-469): the
        outer loop advances output-interval chunks, each one call into the
        engine. ``options`` is an :class:`~parcels_tpu_torch.EngineOptions`.
        """
        from parcels_tpu_torch._core.options import EngineOptions

        opts = options if options is not None else EngineOptions()
        if not isinstance(opts, EngineOptions):
            raise TypeError(f"options must be an EngineOptions. Got {type(opts)}")
        with opts.applied():
            return self._execute_impl(kernels, dt, endtime, runtime, output_file, verbose_progress)

    def _execute_impl(self, kernels, dt, endtime, runtime, output_file, verbose_progress):
        if len(self) == 0:
            return
        if isinstance(kernels, types.FunctionType):
            kernels = [kernels]
        if not isinstance(kernels, list) or len(kernels) == 0:
            raise ValueError(f"kernels must be a non-empty list or a function. Got {kernels!r}")
        for f in kernels:
            if not callable(f):
                raise TypeError(f"kernels must be callables. Got {type(f)}")
            _check_kernel_signature(f)
        self._check_kernel_prerequisites(kernels)

        dt, sign_dt = _convert_dt_to_float(dt)
        runtime = _convert_runtime_to_float(runtime)
        # time plumbing sees only ACTIVE lanes (padding lanes carry t=0)
        active = _host(self._data["_active"])
        tarr = _host(self._data["t"])
        release_t = tarr[active]
        start_time, end_time = _get_simulation_start_and_end_times(
            self.fieldset.time_interval, release_t, runtime, endtime, sign_dt
        )

        d = self._data
        d["dt"] = torch.full_like(d["dt"], dt)
        if np.isnan(tarr).any():
            tarr = tarr.copy()
            tarr[np.isnan(tarr)] = start_time
            d["t"] = _to_device(tarr, self.device)

        outputdt = output_file.outputdt if output_file else None
        _warn_outputdt_release_desync(outputdt, start_time, release_t)

        rk45_mode = "RK45_tol" in self.fieldset.context
        z_occ = self._set_sampler_occupancy_hint()
        # reference kernel.py:190: every execute() call requeues all active lanes
        d["state"] = torch.where(d["_active"], int(StatusCode.Evaluate), d["state"]).to(torch.int32)
        # persistent C-grid cell cache (ops/stagecache.py) and its UGRID twin
        # (ops/uxcache.py): inject the SoA columns before padding, so padded
        # lanes get invalid keys too
        from parcels_tpu_torch.ops import stagecache, uxcache

        sc_ok, sc_w = stagecache.soa_cache_applicable(self.fieldset)
        if sc_ok and stagecache.SC_KEY not in d:
            d.update(stagecache.make_soa_cache(d["state"].shape[0], sc_w, self.device))
        uxc_ok, uxc_meta = uxcache.soa_cache_applicable(self.fieldset)
        if uxc_ok and uxcache.UXC_KEY not in d:
            d.update(uxcache.make_soa_cache(d["state"].shape[0], uxc_meta, self.device))

        domain = self.__dict__.get("_domain")
        pmesh = self.__dict__.get("_pmesh")
        sharded = domain if domain is not None else pmesh
        if domain is None:
            if pmesh is None:
                self._pad_capacity(DEFAULT_BLOCK_SIZE)
            if _sort_mode_enabled(self.fieldset) and not bool(self._data["ei"].any()):
                # sort keys come from the ei cache; seed it so the FIRST chunk
                # bins correctly instead of overflowing to the gather fix-up
                self.populate_indices()
        windowed = self.fieldset._time_window is not None
        f32 = dict(dtype=torch.float32, device=self.device)
        dt_dev = torch.tensor(dt, **f32)
        if domain is not None:
            from parcels_tpu_torch.parallel import build_domain_executor, build_tile_executor
            from parcels_tpu_torch.parallel.tiles import XYTileDomain

            build = build_tile_executor if isinstance(domain, XYTileDomain) else build_domain_executor
            executor = build(tuple(kernels), domain, sign_dt=sign_dt, rk45_mode=rk45_mode,
                             z_occ=z_occ)
            dev = domain.shard_soa(self._data)
            sent0, steps0 = domain.stats["sent"], domain.stats["steps"]

            def step(farrays, dev, endtime):
                return executor(farrays, dev, endtime, dt_dev.to(domain.device))

            def window(t0, t1):
                return domain.stacked_windowed(t0, t1)

            farrays = None if windowed else domain.stacked_farrays()
        else:
            def step(farrays, dev, endtime):
                return run_chunk(self.fieldset, kernels, farrays, dev, endtime,
                                 dt_dev.to(endtime.device), sign_dt=sign_dt,
                                 rk45_mode=rk45_mode, z_occ=z_occ)

            if pmesh is not None:
                dev = pmesh.shard_soa(self._data)

                def window(t0, t1):
                    return pmesh.shard_fields(self.fieldset.windowed_arrays(t0, t1))

                farrays = None if windowed else pmesh.shard_fields(self.fieldset.device_arrays())
            else:
                dev = dict(self._data)
                window = self.fieldset.windowed_arrays
                farrays = None if windowed else self.fieldset.device_arrays()
        run_device = dev["state"].device
        window_key = None
        if sharded is not None:
            from parcels_tpu_torch.parallel import _comm

            comm0 = _comm.comm_stats()  # this run's collectives are counted from here

        if output_file is not None:
            output_file.set_metadata(self.fieldset, self._pclass, kernels)
            output_file.write_snapshot(dict(dev), start_time)
            next_output = start_time + outputdt * sign_dt
        else:
            next_output = None

        pbar = None
        if verbose_progress:
            from tqdm import tqdm

            pbar = tqdm(total=sign_dt * (end_time - start_time))

        wall0 = _time.perf_counter()
        nchunks = 0
        time = start_time
        # cap the steps per chunk; lengths come from a measured per-step cost
        # model (EWMA seconds per step) targeting ``chunk_target_seconds``
        max_chunk = int(os.environ.get("PARCELS_TPU_MAX_CHUNK_STEPS", 64))
        target_s = float(os.environ.get("PARCELS_TPU_CHUNK_TARGET_SECONDS", 20.0))
        # RK45 trajectories depend on where chunk endtimes force landings, so
        # wall-time-driven chunk lengths would make them nondeterministic
        adaptive = target_s > 0 and max_chunk > 0 and bool(dt) and not rk45_mode
        cur_chunk = min(max_chunk, 2) if adaptive else max_chunk
        est_per_step = None
        t_mark = _time.perf_counter()
        try:
            # on one card the host reads chunk k's flags after starting chunk
            # k+1; the chunk-start requeue keeps error/Stop lanes, so a chunk
            # after a halted one is a no-op and the deferred check sees
            # identical state. Over ranks every chunk is drained at once, with
            # its flags and step time reduced over the ranks, so every rank
            # takes the same decisions and chunk lengths.
            def drain(pending):
                nonlocal est_per_step, cur_chunk, t_mark
                flags, steps_done, idx = pending
                now = _time.perf_counter()
                w = max(now - t_mark, 1e-6) / steps_done
                if sharded is not None:
                    us = torch.tensor([int(w * 1e6)], device=flags.device)
                    host = _comm.allreduce_max(torch.cat([flags.to(torch.int64), us]))
                    w = float(host[-1]) / 1e6
                    err_any, stop_any, migof, haloof = (int(v) for v in host[:4].tolist())
                else:
                    err_any, stop_any, migof, haloof = (int(v) for v in flags.tolist())
                if adaptive and idx > 0:
                    est_per_step = w if est_per_step is None else 0.5 * est_per_step + 0.5 * w
                    cur_chunk = max(1, min(max_chunk, int(target_s / est_per_step)))
                t_mark = now
                # domain diagnostics outrank per-particle states: a halo or
                # buffer breach invalidates the samples that made those states
                if migof:
                    raise RuntimeError(
                        "Particle migration buffer overflow: increase "
                        "YBandDomain(headroom=..., migration_capacity=...) or halo."
                    )
                if haloof and (not domain.curvilinear or self._curvilinear_halo_breach(
                        dev, kernels, pending_span[0], pending_span[1], dt, sign_dt,
                        rk45_mode, windowed)):
                    raise RuntimeError(
                        "Halo violation: a particle moved beyond its band's halo-extended "
                        "slab in a single step, so its field samples were clamped at the "
                        "slab edge (rectilinear bands) or its point-in-cell walk failed "
                        "(curvilinear bands). Increase YBandDomain(halo=...) or reduce dt "
                        "(halo must cover the max per-step displacement in cells)."
                    )
                if err_any:
                    self._raise_errors(dev, sharded is not None)
                return bool(stop_any)

            pending = None
            pending_span = (start_time, start_time)
            while sign_dt * (time - end_time) < 0:
                f = min if sign_dt > 0 else max
                next_time = f(next_output, end_time) if next_output is not None else end_time
                if cur_chunk > 0 and dt:
                    next_time = f(next_time, time + sign_dt * cur_chunk * abs(dt))
                if windowed:
                    next_time = f(next_time, self.fieldset.max_window_endtime(time, sign_dt))
                    key = self.fieldset._window_offsets(time, next_time)
                    if key != window_key:
                        # a new window: the persistent caches hold face values
                        # at the previous window's time indices (the JAX package
                        # invalidates at every windowed chunk; the caches are
                        # exact, so a hit inside one window equals a repair)
                        dev = stagecache.invalidate_soa_cache(dev)
                        # drop the old window before the new one lands: the
                        # chunk reads one window while its successor is staged
                        window_key, farrays = key, None
                        if pending is not None:
                            # rollover drains the pipeline, so at most two
                            # windows' slabs are live at once
                            stop0 = drain(pending)
                            pending = None
                            if stop0:
                                break
                    farrays = window(time, next_time)
                if windowed and sign_dt * (next_time - end_time) < 0:
                    # stage the next window while this chunk runs. The chunk's
                    # eager steps occupy this thread until it returns, so the
                    # read is issued before it (the JAX package issues it after
                    # its asynchronous dispatch). Forward chunks anchor at
                    # next_time, backward ones at an estimate (a miss costs one
                    # synchronous load)
                    anchor = next_time if sign_dt > 0 else next_time + (next_time - time)
                    (domain or self.fieldset).prefetch_window(anchor)
                dev = step(farrays, dev, torch.tensor(np.float32(next_time), dtype=torch.float32,
                                                      device=run_device))
                act, st = dev["_active"], dev["state"]
                zero = torch.zeros((), dtype=torch.bool, device=run_device)
                flags = torch.stack([
                    (act & (st >= MIN_ERROR_CODE)).any(),
                    (act & (st == StatusCode.StopAllExecution)).any(),
                    dev["_migof"] > 0 if "_migof" in dev else zero,
                    dev["_haloof"] > 0 if "_haloof" in dev else zero,
                ])
                stop_prev = False
                if pending is not None:
                    stop_prev = drain(pending)
                steps_done = max(1, round(abs(float(next_time) - float(time)) / abs(dt))) if dt else 1
                pending = (flags, steps_done, nchunks)
                pending_span = (time, next_time)

                if sharded is not None or (
                        next_output is not None and abs(next_time - next_output) < 1e-3):
                    # a snapshot must reflect a chunk already checked for errors
                    stop_prev = drain(pending) or stop_prev
                    pending = None
                if next_output is not None and abs(next_time - next_output) < 1e-3:
                    if output_file:
                        output_file.write_snapshot(dict(dev), next_output)
                    if np.isfinite(outputdt):
                        next_output += outputdt * sign_dt
                if pbar is not None:
                    pbar.update(sign_dt * (next_time - time))
                time = next_time
                nchunks += 1
                if stop_prev:
                    break
            if pending is not None:
                drain(pending)
        finally:
            if pbar is not None:
                pbar.close()
            if sharded is None:
                self._data = dev
            else:
                from parcels_tpu_torch.parallel.sharding import gather_lanes

                gather0 = _time.perf_counter()
                self._data = gather_lanes(dev, self.device)
                if run_device.type == "cuda":
                    torch.cuda.synchronize(run_device)
                gather_s = _time.perf_counter() - gather0
            if run_device.type == "cuda":
                torch.cuda.synchronize(run_device)
            wall = _time.perf_counter() - wall0
            stats = {}
            if sharded is not None:
                # rank 0's wall clock, the lanes of every rank
                walls = _comm.host_rows([wall])
                wall = float(walls[0, 0])
                if domain is not None:
                    moved = _comm.host_rows([domain.stats["sent"] - sent0,
                                             domain.stats["steps"] - steps0])
                    stats = {"ranks": int(walls.shape[0]),
                             "migrated_lanes": int(moved[:, 0].sum()),
                             "migrated_per_step": float(moved[:, 0].sum() / max(moved[0, 1], 1))}
                else:
                    stats = {"ranks": int(walls.shape[0])}
                comm = _comm.comm_stats()
                # this run's collectives on this rank
                stats["comm"] = {k: v - comm0[k] if k != "transport" else v
                                 for k, v in comm.items()}
                # the final gather of the lanes to every rank, on this rank
                stats["gather_s"] = round(gather_s, 4)
            nsteps = abs(time - start_time) / abs(dt) if dt else 0.0
            self.last_run_stats = {
                "wall_s": round(wall, 4),
                "chunks": nchunks,
                "particles": len(self),
                "particle_steps_per_s": round(len(self) * nsteps / wall, 1) if wall > 0 else 0.0,
                "z_occupancy_hint": z_occ,
                "chunk_steps_final": cur_chunk,
                "est_seconds_per_step": round(est_per_step, 6) if est_per_step is not None else None,
                **stats,
            }
            if output_file is not None:
                output_file.flush()

    def _curvilinear_halo_breach(self, dev, kernels, time, next_time, dt, sign_dt, rk45_mode,
                                 windowed) -> bool:
        """Tell a curvilinear band's halo breach from a particle leaving the grid.

        A lane that out-ran its band's slab fails its point-in-cell walk,
        though its step is valid on the GLOBAL grid (a halo breach: the
        increase-halo message); a lane that left the grid fails there too
        (its typed error, as on one card). Each rank replays one step of its
        failing lanes on the fieldset's global tensors; a breach is when
        every rank's failing lanes pass. Error path only.
        """
        from parcels_tpu_torch._core.engine import engine_step
        from parcels_tpu_torch.parallel import _comm

        err = dev["_active"] & (dev["state"] == StatusCode.ErrorGridSearching)
        ok = True
        if bool(err.any()):
            farrays = (self.fieldset.windowed_arrays(time, next_time) if windowed
                       else self.fieldset.device_arrays())
            fsview = self.fieldset.build_views(farrays)
            idx = torch.nonzero(err).flatten().to(self.device)
            from parcels_tpu_torch.ops.stagecache import invalidate_soa_cache

            sub = {k: v if k in ("_rng", "_migof", "_haloof") else v.to(self.device)[idx]
                   for k, v in dev.items()}
            # the lanes' cached cells are in their slab's frame
            sub = invalidate_soa_cache(sub)
            sub["ei"] = torch.zeros_like(sub["ei"])
            sub["state"] = torch.full_like(sub["state"], int(StatusCode.Evaluate))
            sub["_active"] = torch.ones_like(sub["_active"])
            for d in ("dx", "dy", "dz"):
                sub[d] = torch.zeros_like(sub[d])
            f32 = dict(dtype=torch.float32, device=self.device)
            out = engine_step(fsview, sub, torch.tensor(np.float32(next_time), **f32),
                              torch.tensor(np.float32(dt), **f32), kernels, sign_dt, rk45_mode)
            ok = bool((out["state"] < MIN_ERROR_CODE).all())
        return int(_comm.allreduce_max(torch.tensor([int(not ok)]))[0]) == 0

    def _raise_errors(self, dev, sharded: bool = False):
        """Raise the typed error of the first lane in an error state; over
        ranks, of the first such lane of the lowest rank that has one, on
        every rank."""
        states = _host(dev["state"])
        err = _host(dev["_active"]) & (states >= MIN_ERROR_CODE)
        row = [0.0] * 6
        if err.any():
            idx = int(np.argmax(err))
            row = [1.0, float(states[idx])] + [float(dev[v][idx]) for v in ("z", "y", "x", "t")]
        if sharded:
            from parcels_tpu_torch.parallel import _comm

            rows = _comm.host_rows(row)
            hit = np.flatnonzero(rows[:, 0])
            row = list(rows[hit[0]]) if hit.size else row
        if row[0]:
            raise_error_from_state(int(row[1]), z=row[2], y=row[3], x=row[4], t=row[5])

    def _check_kernel_prerequisites(self, kernels):
        """RK45 context defaults (reference kernel.py:122-161)."""
        from parcels_tpu_torch.kernels import AdvectionRK45

        for f in kernels:
            if f is not AdvectionRK45:
                continue
            if "next_dt" not in self._pclass.var_names():
                raise ValueError('ParticleClass requires a "next_dt" for AdvectionRK45 Kernel.')
            fs = self.fieldset
            if "RK45_tol" not in fs.context:
                warnings.warn(
                    "Setting RK45 tolerance to 10 m. Use fieldset.add_context('RK45_tol', [distance]) to change.",
                    KernelWarning, stacklevel=2,
                )
                fs.add_context("RK45_tol", 10)
                if fs.gridset and fs.gridset[0].mesh.is_spherical():
                    fs.context["RK45_tol"] = fs.context["RK45_tol"] / fs.gridset[0].deg2m
            if "RK45_min_dt" not in fs.context:
                warnings.warn(
                    "Setting RK45 minimum timestep to 1 s. Use fieldset.add_context('RK45_min_dt', [timestep]) to change.",
                    KernelWarning, stacklevel=2,
                )
                fs.add_context("RK45_min_dt", 1)
            if "RK45_max_dt" not in fs.context:
                warnings.warn(
                    "Setting RK45 maximum timestep to 1 day. Use fieldset.add_context('RK45_max_dt', [timestep]) to change.",
                    KernelWarning, stacklevel=2,
                )
                fs.add_context("RK45_max_dt", 60 * 60 * 24)

    def _pad_capacity(self, block_size: int):
        """Pad the SoA with inactive lanes to ``padded_capacity``."""
        n = self._data["state"].shape[0]
        pad = padded_capacity(n, block_size) - n
        if pad == 0:
            return
        out = {}
        for k, v in self._data.items():
            if k == "_rng":
                out[k] = v
                continue
            # -1 sentinels: padded lanes must never look like live ids or
            # valid persistent-cache cells (cell 0 is real)
            fill = torch.full((pad,) + tuple(v.shape[1:]),
                              -1 if k in ("particle_id", "_sc_key", "_uxc_key") else 0,
                              dtype=v.dtype, device=v.device)
            out[k] = torch.cat([v, fill])
        out["_active"][n:] = False
        self._data = out

    def _set_sampler_occupancy_hint(self) -> float:
        """Quantized fraction of z-cells the live batch occupies, for the
        binned planner (a surface-only release occupies 1 of Z cells)."""
        from parcels_tpu_torch.ops.binned_sample import quantize_z_occupancy

        frac = 1.0
        depth = max((np.asarray(g.depth) for g in self.fieldset.gridset),
                    key=lambda d: d.size, default=None)
        if depth is not None and depth.ndim == 1 and depth.size > 2 and bool(np.all(np.diff(depth) > 0)):
            z = _host(self._data["z"])
            act = _host(self._data["_active"])
            z = z[act] if act.any() else z
            zi = np.clip(np.searchsorted(depth, z, side="right") - 1, 0, depth.size - 2)
            frac = np.unique(zi).size / max(depth.size - 1, 1)
        return quantize_z_occupancy(frac)


class _ParticleRecord:
    """Read-only row view yielded by ``iter(ParticleSet)``, over host
    columns."""

    __slots__ = ("_data", "_i")

    def __init__(self, data, i):
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "_i", i)

    def __getattr__(self, name):
        data = object.__getattribute__(self, "_data")
        if name in data:
            return data[name][object.__getattribute__(self, "_i")]
        raise AttributeError(name)

    def __repr__(self):
        d, i = self._data, self._i
        fields = ", ".join(f"{k}={d[k][i]:.6g}" for k in ("x", "y", "z", "t") if k in d)
        pid = d["particle_id"][i] if "particle_id" in d else i
        return f"Particle(id={pid}, {fields})"


def _check_kernel_signature(f):
    """Kernels must accept exactly (particles, fieldset) (reference kernel.py:70)."""
    import inspect

    try:
        params = [
            p for p in inspect.signature(f).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        ]
    except (TypeError, ValueError):
        return
    if len(params) != 2:
        raise ValueError(
            f"Kernel {getattr(f, '__name__', f)!r} must have signature "
            f"(particles, fieldset); got {len(params)} positional parameters."
        )


def _warn_outputdt_release_desync(outputdt, starttime, release_times):
    if not outputdt:
        return
    rt = np.asarray(release_times)
    finite = np.isfinite(rt)
    if np.any(np.mod(rt[finite] - starttime, outputdt) != 0):
        warnings.warn(
            "Some of the particles have a start time difference that is not a multiple of outputdt. "
            "This could cause the first output of some of the particles that start later "
            "in the simulation to be at a different time than expected.",
            ParticleSetWarning,
            stacklevel=2,
        )


def _warn_release_outside_bounds(release_times, time_interval):
    if np.isnan(release_times).all():
        return
    length = timedelta_to_float(time_interval.right - time_interval.left)
    if np.any(release_times < 0) or np.any(release_times > length):
        warnings.warn(
            "Some particles are set to be released outside the FieldSet's executable time domain.",
            ParticleSetWarning,
            stacklevel=2,
        )


def _convert_dt_to_float(dt):
    try:
        dt = timedelta_to_float(dt)
        sign_dt = int(np.sign(dt))
    except (ValueError, TypeError) as e:
        raise ValueError(
            f"dt must be a non-zero datetime.timedelta or np.timedelta64 object, got {dt!r}"
        ) from e
    if sign_dt not in (-1, 1):
        raise ValueError(f"dt must be a non-zero datetime.timedelta or np.timedelta64 object, got {dt!r}")
    return dt, sign_dt


def _convert_runtime_to_float(runtime):
    if runtime is None:
        return None
    try:
        runtime = timedelta_to_float(runtime)
    except (ValueError, TypeError) as e:
        raise ValueError(
            f"The runtime must be a datetime.timedelta, np.timedelta64 or float object. Got {type(runtime)}"
        ) from e
    if runtime < 0:
        raise ValueError(f"The runtime must be a non-negative timedelta or float. Got {runtime!r}")
    return runtime


def _get_simulation_start_and_end_times(time_interval, release_times, runtime, endtime, sign_dt):
    """Resolve (start, end) float seconds (reference particleset.py:522-584)."""
    if runtime is not None and endtime is not None:
        raise ValueError(
            f"runtime and endtime are mutually exclusive - provide one or the other. "
            f"Got runtime={runtime!r}, endtime={endtime!r}"
        )
    if runtime is None and time_interval is None:
        raise ValueError("The runtime must be provided when the time_interval is not defined for a fieldset.")
    if runtime is None and endtime is None:
        raise ValueError("Either runtime or endtime must be provided.")

    release_times = np.asarray(release_times, dtype=np.float64)
    finite = release_times[np.isfinite(release_times)]
    if sign_dt == 1:
        first_release = finite.min() if finite.size else np.nan
    else:
        first_release = finite.max() if finite.size else np.nan

    if time_interval is not None and endtime is not None:
        if isinstance(endtime, (np.datetime64, np.timedelta64)) or type(endtime) is type(time_interval.left):
            if endtime not in time_interval:
                raise ValueError(
                    f"Provided end time {endtime!r} is not in fieldset time interval {time_interval!r}."
                )
            endtime = timedelta_to_float(endtime - time_interval.left)
        else:
            raise ValueError(
                f"The endtime must be of the same type as the fieldset.time_interval start time. "
                f"Got {endtime!r} with {time_interval!r}"
            )

    if time_interval is None:
        fieldset_start = 0.0 if sign_dt == 1 else float(runtime)
    else:
        fieldset_start = (
            0.0 if sign_dt == 1 else timedelta_to_float(time_interval.right - time_interval.left)
        )

    start_time = float(first_release) if np.isfinite(first_release) else fieldset_start
    if endtime is None:
        endtime = start_time + sign_dt * float(runtime)
    return start_time, float(endtime)
