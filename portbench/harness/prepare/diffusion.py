"""Constant diffusivity fields and their central-difference step, for the
stochastic kernels (as Parcels' diffusion tutorial sets them)."""


def apply(fs, params: dict) -> None:
    fs.add_constant_field("Kh_zonal", float(params["kh"]), mesh="spherical")
    fs.add_constant_field("Kh_meridional", float(params["kh"]), mesh="spherical")
    fs.add_context("dres", float(params["dres"]))
