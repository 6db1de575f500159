"""Launch counts of every hand-written kernel, read and reset in one place.

Each wrapper module keeps a ``launches`` dict that it raises where it launches
a kernel (never in a plain version). Here they are read under one name per
kernel, ``<prefix><key>`` (``flash_attention_fwd_tc``,
``msda_corner_reduce_bwd``, ``jv_assign``, ``probe_gather_global``, ...), the names of the
``kernels`` line that ``chip_smoke.py`` prints and of the trainer's
``steps.jsonl``.
"""

from __future__ import annotations


def _counted_modules():
    from ..probes import dyngather, msda_lab, stream
    from ..spotter import matcher
    from . import flash_attention, msda_reduce, patchify, quant

    return (
        ("flash_attention_", flash_attention), ("msda_corner_reduce_", msda_reduce),
        ("patchify_value_", patchify), ("w8a8_", quant), ("jv_", matcher),
        ("probe_gather_", dyngather),
        ("probe_stream_", stream), ("probe_msda_lab_", msda_lab),
    )


def reset_launch_counts() -> None:
    for _, module in _counted_modules():
        module.reset_launches()


def launch_counts() -> dict:
    """Every wrapper's launches since the last reset, by kernel name."""
    return {
        prefix + key: n for prefix, module in _counted_modules()
        for key, n in module.launches.items()
    }
