"""rsaudioecho: echo/reverb on tensors.

The port of gstpu's rsaudioecho (gstpu/elements/audio/audiofx.py). On
its own, a host buffer is uploaded once to the element's device, the
echo runs there (gstpu_torch.ops.echo) with the tail state on that
device, and the result stays a tensor in `buf.data`. With `context`
set, the element joins that DeviceContext (gstpu_torch.runtime.
device_batch): its stream runs batched with every other member's, as
one step per block round, and the outputs leave from the chain's tail.
"""

from __future__ import annotations

import torch

from gstpu_torch.core.audio import AudioInfo, audio_caps
from gstpu_torch.core.base import AudioFilter
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.device import default_device
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.ops.echo import echo_block, make_state
from gstpu_torch.runtime.device_batch import (DeviceContext, DeviceRow,
                                              _is_device)

SECOND = 1_000_000_000

_ECHO_CAPS = audio_caps(formats=("F64LE", "F32LE"))


def _tmpl(name, direction):
    return PadTemplate(name, direction, PadPresence.ALWAYS,
                       _ECHO_CAPS.copy())


@register_element("rsaudioecho", Rank.NONE)
class AudioEcho(AudioFilter):
    """Echo/reverb filter.

    Properties mirror the reference (audioecho/imp.rs:96-133): delay and
    max-delay in ns, only mutable up to READY; intensity/feedback are
    the f64 uniforms, mutable while playing.
    """

    IN_PLACE = True
    PAD_TEMPLATES = [_tmpl("sink", PadDirection.SINK),
                     _tmpl("src", PadDirection.SRC)]

    max_delay = Property(int, default=1 * SECOND, minimum=1,
                         mutable=Mutability.READY,
                         blurb="Maximum echo delay (ns)")
    delay = Property(int, default=SECOND // 2, minimum=1,
                     mutable=Mutability.READY, blurb="Echo delay (ns)")
    intensity = Property(float, default=0.5, minimum=0.0, maximum=1.0,
                         mutable=Mutability.PLAYING)
    feedback = Property(float, default=0.0, minimum=0.0, maximum=1.0,
                        mutable=Mutability.PLAYING)
    context = Property(str, default=None, mutable=Mutability.READY,
                       blurb="DeviceContext name: elements sharing it "
                             "run as ONE batched step per block round "
                             "(threadshare context analogue)")
    context_block = Property(int, default=None, minimum=64,
                             mutable=Mutability.READY,
                             blurb="Batch block size in flattened "
                                   "samples (context members agree; "
                                   "default 19200)")

    def __init__(self, name=None):
        super().__init__(name)
        self._tail: torch.Tensor | None = None
        self._delay_samples = 0
        self._size = 0
        self._device: torch.device | None = None
        self._ctx = None

    def start(self) -> bool:
        self._device = default_device()
        # join the batching window BEFORE data flows (threadshare's
        # Context::acquire in the READY state change): membership is
        # complete before the first batch can fire
        if self.context:
            self._ctx = DeviceContext.acquire(self.context,
                                              self.context_block)
            self._ctx.add_member(self)
        return True

    def setup(self, info: AudioInfo) -> bool:
        # delay/size in flattened interleaved samples, floor division —
        # matches reference delay_frames computation (imp.rs:74-78)
        size = max((self.max_delay * info.rate * info.channels) // SECOND, 1)
        d = max((self.delay * info.rate * info.channels) // SECOND, 1)
        self._delay_samples = min(d, size)
        self._size = size
        if self._ctx is not None:
            self._ctx.finalize_member(self)
            self._tail = None
        else:
            self._tail = make_state((), size, device=self._device)
        return True

    # -- DeviceContext contract (runtime/device_batch.py) ---------------
    def device_batch_spec(self) -> dict:
        d, size, device = self._delay_samples, self._size, self._device

        def step(states, x, intensity, feedback):
            return echo_block(states, x, intensity, feedback, delay=d)

        return dict(key=("rsaudioecho", d, size),
                    step=step,
                    init_state=lambda: make_state((), size, device=device),
                    uniforms=lambda: (self.intensity, self.feedback),
                    # echo_block handles any width: required when this
                    # element feeds a priming stage (audioloudnorm's
                    # 3 s first frame) in a fused chain
                    wide_ok=True)

    def make_batch_buffer(self, flat, pts, dur) -> Buffer:
        if isinstance(flat, DeviceRow):
            return Buffer(flat, pts=pts, duration=dur)
        return Buffer(flat.reshape(-1, self.audio_info.channels),
                      pts=pts, duration=dur)

    def transform_ip(self, buf: Buffer):
        info = self.audio_info
        if self._ctx is not None:
            data = buf.data if _is_device(buf.data) \
                else info.view(buf).reshape(-1)
            self._ctx.submit(self, data, buf.pts,
                             info.rate * info.channels)
            return []                   # outputs flow from the batch
        x = info.tensor(buf, self._device).reshape(-1)
        self._tail, out = echo_block(
            self._tail, x.to(self._tail.device), self.intensity,
            self.feedback, delay=self._delay_samples)
        buf.data = out.reshape(-1, info.channels)

    def drain(self) -> list[Buffer]:
        if self._ctx is not None:
            return self._ctx.flush_member(self)
        return []

    def stop(self) -> bool:
        if self._ctx is not None:
            self._ctx.remove_member(self)
            self._ctx = None
        return super().stop()

    def flush(self) -> None:
        if self._tail is not None:
            self._tail = torch.zeros_like(self._tail)
