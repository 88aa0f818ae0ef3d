"""Reporting layer: matplotlib plot suite, HTML report, LaTeX export,
reaction diagrams.

Names are imported on first use, so the matplotlib-free parts (HTML
explorers, the report index) load where matplotlib is not installed."""

import importlib

_EXPORTS = {
    "illustrate": "diagram",
    "create_report": "html",
    "render_kinopt_app": "apps",
    "render_tfopt_app": "apps",
    "LiveMonitor": "live",
    "dataframe_to_latex": "latexit",
    "figure_to_latex": "latexit",
    "write_latex_report": "latexit",
    "Plotter": "plotter",
    "plot_convergence": "plotter",
    "plot_parallel_coords_pareto": "plotter",
    "plot_pareto_3d": "plotter",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
