"""The program's own spans over a traced window (`lidar_snow_sim_tpu_torch.
utils.profiling`: recorded while the harness's torch.profiler session
runs, so over the units of `run.scans_traced`), summed by layer for the
per-layer metrics that read them.

The layers are disjoint, so their host times add up to the entry calls':
- entry points: the self time of the `augmenter.*` spans and of
  `batched.step`, `batched.draws` and `batched.pack_out`;
- snowfall orchestration: the self time of `batched.core` and of the
  `snowfall.*` spans that are not kernel calls;
- kernels: the whole time of the kernel calls (each wrapper's host work
  and its launches), `snowfall.window_kernels`, `snowfall.phase_a` and
  `snowfall.phase_c`.

A program without the tracer, or a window in which it recorded nothing,
gives None.
"""

from __future__ import annotations

KERNEL_CALLS = ("snowfall.window_kernels", "snowfall.phase_a",
                "snowfall.phase_c")
ENTRY = ("batched.step", "batched.draws", "batched.pack_out")


def layer(name: str) -> str | None:
    """The layer a span's time counts in: "entry", "orchestration",
    "kernel_calls", or None for a span of no layer."""
    if name in KERNEL_CALLS:
        return "kernel_calls"
    if name in ENTRY or name.startswith("augmenter."):
        return "entry"
    if name == "batched.core" or name.startswith("snowfall."):
        return "orchestration"
    return None


def spans(run):
    """The spans the program recorded over the traced window, or None."""
    if not run.scans_traced:
        return None
    try:
        from lidar_snow_sim_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    return recorded() or None


def layer_ms(run, name: str):
    """Host ms a scan of layer `name`: self time, or for the kernel calls
    the whole time, over the traced window's scans."""
    rec = spans(run)
    if rec is None:
        return None
    from lidar_snow_sim_tpu_torch.utils.profiling import self_ns

    ns = sum(s.end_ns - s.start_ns if name == "kernel_calls" else self_ns(s)
             for s in rec if layer(s.name) == name)
    return ns / 1e6 / run.scans_traced


def span_ms(run, span_name: str):
    """Host ms a scan of the spans named `span_name`, whole."""
    rec = spans(run)
    if rec is None:
        return None
    ns = sum(s.end_ns - s.start_ns for s in rec if s.name == span_name)
    return ns / 1e6 / run.scans_traced


def host_syncs(run):
    """Host syncs a scan, over all the window's spans."""
    rec = spans(run)
    if rec is None:
        return None
    return sum(s.host_syncs for s in rec) / run.scans_traced
