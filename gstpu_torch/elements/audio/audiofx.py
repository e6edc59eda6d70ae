"""rsaudioecho: echo/reverb on tensors.

The port of gstpu's rsaudioecho (gstpu/elements/audio/audiofx.py), its
per-buffer device path: a host buffer is uploaded once to the element's
device, the echo runs there (gstpu_torch.ops.echo) with the tail state
on that device, and the result stays a tensor in `buf.data`.

The `context` property (DeviceContext batching of many pipelines into
one dispatch) is not ported yet: an element with `context` set refuses
to start instead of running unbatched.
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
                       blurb="DeviceContext name (not ported yet: an "
                             "element with it set does not start)")

    def __init__(self, name=None):
        super().__init__(name)
        self._tail: torch.Tensor | None = None
        self._delay_samples = 0
        self._size = 0
        self._device: torch.device | None = None

    def start(self) -> bool:
        if self.context:
            raise NotImplementedError(
                f"rsaudioecho context={self.context!r}: DeviceContext "
                f"batching is not ported to gstpu_torch yet; unset "
                f"`context` to run the per-buffer device path")
        self._device = default_device()
        return True

    def setup(self, info: AudioInfo) -> bool:
        # delay/size in flattened interleaved samples, floor division —
        # matches reference delay_frames computation (imp.rs:74-78)
        size = max((self.max_delay * info.rate * info.channels) // SECOND, 1)
        d = max((self.delay * info.rate * info.channels) // SECOND, 1)
        self._delay_samples = min(d, size)
        self._size = size
        self._tail = make_state((), size, device=self._device)
        return True

    def transform_ip(self, buf: Buffer) -> None:
        info = self.audio_info
        x = info.tensor(buf, self._device).reshape(-1)
        self._tail, out = echo_block(
            self._tail, x.to(self._tail.device), self.intensity,
            self.feedback, delay=self._delay_samples)
        buf.data = out.reshape(-1, info.channels)

    def flush(self) -> None:
        if self._tail is not None:
            self._tail = torch.zeros_like(self._tail)
