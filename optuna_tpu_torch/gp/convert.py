"""Carry fitted GP state from the reference package into the port.

The reference's ``GPParams``/``GPState`` hold JAX arrays; these helpers
take anything ``numpy.asarray`` reads (JAX arrays included, without
importing JAX here), by attribute or by mapping key, and build the port's
tensors on ``device``. With them both packages can evaluate the posterior
and every acquisition of one fitted model (:func:`acqf_data_from_numpy`,
stacked states included), and :func:`scan_carry_from_numpy` starts the
port's scan chunk programs from the reference's loop-top carry.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from optuna_tpu_torch._device import resolve_device
from optuna_tpu_torch.gp.gp import GPParams, GPState


def _field(obj: Any, name: str) -> Any:
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _tensor(a: Any, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True), dtype=dtype).to(device)


def gp_params_from_numpy(params: Any, device: "str | torch.device | None" = None) -> GPParams:
    """GPParams from an object or mapping with ``inv_sq_lengthscales``,
    ``scale`` and ``noise``."""
    dev = resolve_device(device)
    return GPParams(
        *(_tensor(_field(params, f), dev) for f in GPParams._fields)
    )


def gp_state_from_numpy(state: Any, device: "str | torch.device | None" = None) -> GPState:
    """GPState from an object or mapping with ``params``, ``X``, ``y``,
    ``mask``, ``L`` and ``alpha``."""
    dev = resolve_device(device)
    return GPState(
        params=gp_params_from_numpy(_field(state, "params"), dev),
        **{f: _tensor(_field(state, f), dev) for f in GPState._fields if f != "params"},
    )


#: Fields of the acquisition data that hold a (possibly stacked) GPState,
#: a boolean mask, or the wrapped data of a constrained acquisition.
_STATE_FIELDS = ("state", "states", "constraint_states")
_MASK_FIELDS = ("cat_mask", "constraint_cat_mask")


def acqf_data_from_numpy(data: Any, device: "str | torch.device | None" = None):
    """The port's acquisition data (``LogEIData``, ``QLogEIData``,
    ``LogPIData``, ``UCBData``, ``LogEHVIData`` with its stacked states,
    ``ConstrainedData`` around any of them) from the reference's object of
    the same class name: states through :func:`gp_state_from_numpy`,
    masks as bool tensors, every other field a float32 tensor."""
    from optuna_tpu_torch.gp import acqf

    dev = resolve_device(device)
    cls = getattr(acqf, type(data).__name__)
    fields = {}
    for f in cls._fields:
        value = _field(data, f)
        if f == "base":
            fields[f] = acqf_data_from_numpy(value, dev)
        elif f in _STATE_FIELDS:
            fields[f] = gp_state_from_numpy(value, dev)
        elif f in _MASK_FIELDS:
            fields[f] = _tensor(value, dev, torch.bool)
        else:
            fields[f] = _tensor(value, dev)
    return cls(**fields)


def kernel_params_cache_from_numpy(exported: Mapping[str, Any]) -> dict[str, Any]:
    """The reference ``GPSampler.export_fitted_state()`` dict, as one the
    port's ``GPSampler.restore_fitted_state`` accepts: search-space
    signatures as tuples, raw log-params as float32 numpy arrays."""
    cache = exported["kernel_params_cache"]
    return {
        "kernel_params_cache": {
            tuple(tuple(item) for item in sig): [np.asarray(p, dtype=np.float32) for p in raws]
            for sig, raws in cache.items()
        }
    }


#: The tensor fields of the scan loop's loop-top carry (the reference's
#: ``scan_loop.py::_stash_carry``); ``Z``/``zy``/``zm``/``warm_raw`` are None
#: until the loop first needs them.
_SCAN_TENSORS = ("X", "y", "m")
_SCAN_OPTIONAL = ("warm_raw", "Z", "zy", "zm")


def scan_carry_from_numpy(
    stash: Mapping[str, Any], device: "str | torch.device | None" = None
) -> dict[str, Any]:
    """The reference's scan carry (``X``, ``y``, ``m``, ``n_dev``,
    ``warm_raw``, ``Z``, ``zy``, ``zm``, ``bucket``, ``m_pad``; numpy or JAX
    arrays) as the port's: float32 tensors on ``device`` (None stays None),
    the cursor ``n_dev`` and the sizes as Python ints."""
    dev = resolve_device(device)
    carry: dict[str, Any] = {
        "n_dev": int(np.asarray(stash["n_dev"])),
        "bucket": int(stash["bucket"]),
        "m_pad": int(stash["m_pad"]),
    }
    for f in _SCAN_TENSORS:
        carry[f] = _tensor(stash[f], dev)
    for f in _SCAN_OPTIONAL:
        carry[f] = None if stash.get(f) is None else _tensor(stash[f], dev)
    return carry
