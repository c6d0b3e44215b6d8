"""Compute stages of the port: the funnel likelihood (K2 screen, K3
slab gather, K1 fit), the dense likelihood (K1 in dense mode), the
posterior and its MC kernel (K4, with its Philox generator).

The reference engine's functions are re-exported as `brutus_tpu.ops`
re-exports them (`get_seds`, `get_seds_mag`, `get_seds_flux`,
`optimize_mag`, `optimize_flux_step`, `sed_mle`, `loglike_grid`),
lazily, so that importing the package stays light."""

_EXPORTS = {"get_seds": "sed", "get_seds_mag": "sed", "get_seds_flux": "sed",
            "optimize_mag": "optimize", "optimize_flux_step": "optimize",
            "sed_mle": "optimize", "loglike_grid": "optimize"}


def __getattr__(name):
    import importlib
    if name in _EXPORTS:
        return getattr(importlib.import_module(f".{_EXPORTS[name]}",
                                               __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
