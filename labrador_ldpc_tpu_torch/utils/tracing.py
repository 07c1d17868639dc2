"""Named host spans on `torch.profiler`'s timeline.

`span(name, key, value)` is a context manager. While a `torch.profiler`
records it is a `RecordFunction` range named `name`: a host range in the
profiler's own trace, on the clock of every kernel and copy the same trace
holds, kept in the profiler's memory until it ends and exported with the
rest (`export_chrome_trace`). Otherwise it is one shared no-op object, after a
single check: nothing is allocated and no `RecordFunction` is made, so the
spans cost nothing measurable when nobody profiles.

The range is PyTorch's C++ `_RecordFunctionFast`, bound at import: a
PyTorch without it fails there. It is an operation range, not a user
annotation (as `torch.profiler.record_function` makes): the profiler
mirrors none onto the device's timeline, so no span takes a kernel from a
user range opened around it, and it costs the host less than
`record_function` does (PERF.md §6).

Parents are given by nesting on the one host thread: a child lies inside
its parent's interval. `key` and `value` name what a span is of, such as
`("batch", 12)` or `("snr", 1.5)`; the dict of them is made only while a
profiler records, and the profiler keeps it where it records shapes
(`record_shapes=True`, as the CLI's `--profile` does), in the Chrome
trace's "args". A value other than an int is kept as its `str` (the Chrome
trace writer prints the float 2.0 as `2.`, which JSON readers refuse); a
`value` of None gives no args. The spans of the port (README, "Spans"):

    ldpc.decode_ms          ops.minsum.decode_ms, the whole call
      ldpc.copy_in            the LLRs moved to the device
      ldpc.decode             impl lookup and the decoder's call
    ldpc.waterfall          channel.waterfall.waterfall, one call
      ldpc.waterfall.setup    the trial step built, the checkpoint opened
      ldpc.waterfall.point    one SNR point (args snr)
        ldpc.trial_step         one batch enqueued (args batch: its index in the sweep)
          ldpc.draw               data and noise drawn
          ldpc.encode             the encoder's call
          ldpc.channel            the channel (with a sum-product impl, also the
                                  scaling to true LLRs 2y/sigma^2)
          ldpc.decode             the decoder's call (with sp_layered or cuda_sp on
                                  the card, the sumproduct_kernel launch)
          ldpc.count              the batch's counters
        ldpc.waterfall.drain    one batch's counters read back to the host
    ldpc.all_reduce         parallel.mesh.all_reduce_sum on a mesh with a process
                            group (args bytes; one a batch in ldpc.trial_step,
                            after ldpc.count)
    ldpc.all_gather         parallel.mesh.all_gather_rows, the same (args bytes)
    ldpc.broadcast          parallel.mesh.broadcast_object, the same
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["span", "spanned", "OFF"]

# the one object `span` returns while no profiler records; re-entrant
OFF = contextlib.nullcontext()

_recording = torch.autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


def span(name: str, key: str | None = None, value=None):
    """A host range `name` while a `torch.profiler` records, else `OFF`."""
    if not _recording():
        return OFF
    if value is None:
        return _Range(name)
    # its positional inputs must be a list: None ends the process
    return _Range(name, [], {key: value if isinstance(value, int) else str(value)})


def spanned(name: str):
    """Decorator: each call of the function is a span `name`."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _recording():
                return fn(*args, **kwargs)
            with _Range(name):
                return fn(*args, **kwargs)

        return call

    return wrap
