"""Carry configuration and controller state into the port.

The system has no weights: what crosses from another implementation (the JAX
package, a saved run) is a configuration and a controller's state.

* ``config_from_dict`` takes ``dataclasses.asdict`` of a configuration, with enums
  by name or value and lists in place of tuples allowed, and returns the port's
  validated ``Config``.
* ``sampling_state_from_numpy`` wraps an incumbent and a CEM sigma as the port's
  ``SamplingState`` on a device.
* ``set_gradient_state`` gives a ``GradientMPC`` the nominal gradient MPC's
  state (warm start, previous GRFs, integral), and ``set_variant_state`` a
  ``VariantGradientMPC`` a variant controller's (warm start, the carried
  augmented states, previous GRFs), so that two implementations start a tick
  from the same state.
* ``heightmaps_from_numpy`` takes the leaves of a heightmap (a JAX
  ``GridHeightMap``'s, as numpy) and returns the port's ``GridHeightMap``.
* ``scenario_state_from_numpy`` takes a scenario fleet's state (a JAX
  ``ScenarioState`` with a leading scenario axis, or anything with its fields,
  read as numpy) and returns the port's ``ScenarioState``, so that both packages
  step the same fleet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import (Config, CostWeights, GaitParams, GaitType, GradientParams, MPCParams,
                     RobotParams, SamplingParams, SimParams, TamolsParams, validate_config)
from .controllers.sampling.sampling_mpc import SamplingState
from .planner.heightmap import GridHeightMap
from .utils.device import resolve_device


def _tuples(v):
    """Lists (from JSON, say) back to the tuples the frozen dataclasses hold."""
    if isinstance(v, (list, tuple)):
        return tuple(_tuples(x) for x in v)
    return v


def _build(cls, d: dict, **nested):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    kw = {k: _tuples(v) for k, v in d.items() if k not in nested}
    kw.update(nested)
    return cls(**kw)


def _gait_type(v) -> GaitType:
    if isinstance(v, str):
        return GaitType[v]
    return GaitType(int(v))


def config_from_dict(d: dict) -> Config:
    """The port's Config from ``dataclasses.asdict(cfg)`` of an equivalent config."""
    mpc = d["mpc"]
    gait = dict(d["gait_params"], gait_type=_gait_type(d["gait_params"]["gait_type"]))
    cfg = _build(Config, d,
                 robot=_build(RobotParams, d["robot"]),
                 mpc=_build(MPCParams, mpc,
                            sampling=_build(SamplingParams, mpc["sampling"]),
                            gradient=_build(GradientParams, mpc["gradient"]),
                            cost=_build(CostWeights, mpc["cost"])),
                 sim=_build(SimParams, d["sim"]),
                 gait_params=_build(GaitParams, gait),
                 tamols=_build(TamolsParams, d["tamols"]))
    validate_config(cfg)
    return cfg


def sampling_state_from_numpy(best_parameters, sigma, seed: int, offset: int = 0,
                              device="cuda") -> SamplingState:
    """A SamplingState holding ``best_parameters`` (P,) and ``sigma`` (P,) on ``device``."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32).reshape(-1), device=dev).clone()

    return SamplingState(best_parameters=t(best_parameters), seed=int(seed),
                         offset=int(offset), sigma=t(sigma))


def heightmaps_from_numpy(center, yaw, resolution, heights, device="cuda") -> GridHeightMap:
    """A GridHeightMap on ``device`` from its leaves: center (..., 2), yaw (...,),
    resolution and heights (..., R, C), all as float32."""
    dev = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.array(x, np.float32)).to(dev)

    return GridHeightMap(center=t(center), yaw=t(yaw), resolution=t(resolution),
                         heights=t(heights))


def scenario_state_from_numpy(state, seeds, device="cuda"):
    """The port's ``parallel.ScenarioState`` on ``device`` from a fleet state with
    the JAX ``ScenarioState``'s fields (x, feet, phase, swing_time, liftoff,
    prev_contact, terrain, reflex, hitpoint, and mpc's best_parameters and sigma),
    each with a leading scenario axis. The JAX sampling state's PRNG key has no
    counterpart: each scenario gets Philox ``seeds[s]`` at offset 0."""
    from .controllers.sampling.sampling_mpc import FleetSamplingState
    from .parallel.scenario_engine import ScenarioState

    dev = resolve_device(device)

    def t(x, dtype=np.float32):
        return torch.from_numpy(np.array(x, dtype)).to(dev)

    S = np.asarray(state.x).shape[0]
    seeds = np.broadcast_to(np.asarray(seeds, np.int64), (S,))
    return ScenarioState(
        x=t(state.x), feet=t(state.feet), phase=t(state.phase), swing_time=t(state.swing_time),
        liftoff=t(state.liftoff), prev_contact=t(state.prev_contact),
        mpc=FleetSamplingState(t(state.mpc.best_parameters), t(state.mpc.sigma),
                               t(seeds, np.int64), t(np.zeros(S), np.int64)),
        terrain=t(state.terrain), reflex=t(state.reflex), hitpoint=t(state.hitpoint))


def set_gradient_state(mpc, U_warm, previous_grfs, integral):
    """Give a ``GradientMPC`` the state another one carries across ticks: the
    warm start U_warm (H, 12), previous_grfs (4, 3) and the integral (6,), copied
    as numpy arrays (the integral keeps its dtype: the JAX package's turns
    float64 once it is committed)."""
    mpc.U_warm = np.array(U_warm, np.float32).reshape(mpc.dims.horizon, 12)
    mpc.previous_grfs = np.array(previous_grfs, np.float32).reshape(4, 3)
    mpc.integral = np.array(integral).reshape(6)
    return mpc


def set_variant_state(mpc, U_warm, extra_state, previous_grfs):
    """Give a ``VariantGradientMPC`` the state another one carries across ticks:
    the warm start U_warm (H, nu), the augmented states beyond the base
    extra_state (nx - 12: the force states of input_rates, the arm wrench of
    collaborative, lyapunov's z1, z2 and phi) and previous_grfs (4, 3), as
    float32 numpy copies."""
    mpc.U_warm = np.array(U_warm, np.float32).reshape(mpc.dims.horizon, mpc.spec.nu)
    mpc.extra_state = np.array(extra_state, np.float32).reshape(mpc.spec.nx - 12)
    mpc.previous_grfs = np.array(previous_grfs, np.float32).reshape(4, 3)
    return mpc
