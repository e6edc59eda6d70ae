"""gstpu_torch — the PyTorch and CUDA port of gstpu.

The same element and pipeline model as gstpu (caps, buffers, events,
pads, a gst-launch pipeline language), with frames as torch tensors.
The work of each Pallas kernel of gstpu is a hand-written CUDA kernel
for Hopper (gstpu_torch/kernels/), beside a plain PyTorch version that
runs for CPU tensors; gstpu's jit-compiled device code (the audio
chain) is torch ops that run on the device of their inputs. The
package imports nothing of gstpu or JAX.

Layering:
  core/     — Caps/Buffer/Event/Query/Element/Pad/Pipeline/parse, device
  runtime/  — cooperative scheduler
  ops/      — kernel wrappers and their plain versions, the audio DSP
  parallel/ — whole element chains as one batched step
  kernels/  — CUDA sources and their build
  elements/ — the ported elements
  utils/    — tracers, logging
"""

__version__ = "0.1.0"

from gstpu_torch.core.caps import Caps, Structure, IntRange, FractionRange, AnyList
from gstpu_torch.core.buffer import Buffer, BufferFlags
from gstpu_torch.core.event import (
    Event, StreamStartEvent, CapsEvent, SegmentEvent, EosEvent, GapEvent,
    FlushStartEvent, FlushStopEvent, TagEvent, CustomEvent, Segment,
)
from gstpu_torch.core.query import Query, LatencyQuery, CapsQuery, PositionQuery
from gstpu_torch.core.element import (
    Element, Pad, PadTemplate, PadDirection, PadPresence, State,
    FlowReturn, FlowError, Bus, Message,
)
from gstpu_torch.core.props import Property, Mutability
from gstpu_torch.core.registry import register_element, element_factory, Rank, make
from gstpu_torch.core.bin import Bin, Pipeline
from gstpu_torch.core.parse import parse_launch
from gstpu_torch.core.clock import ClockTime, SECOND, MSECOND, USECOND, NSECOND


def init(device=None):
    """Register the port's elements (idempotent) and set the device
    that host frames are uploaded to: `device`, or CUDA when None.
    Raises if CUDA is asked for and there is no CUDA device."""
    from gstpu_torch.core.device import set_default_device
    import gstpu_torch.elements

    set_default_device(device)
    gstpu_torch.elements.register_all()
