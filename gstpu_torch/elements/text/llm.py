"""llamatexttransform: LLM-rewritten text streams.

Rebuilds the reference text/llamacpp llamatexttransform: timed
text/x-raw buffers are fed (with a rolling history and a system
prompt) through a causal language model, and the generated reply is
pushed as text/x-raw with the input's timing. The reference embeds
llama.cpp; here the engine is transformers' AutoModelForCausalLM
loaded strictly locally from model-path (fetching published weights
is the env gate, exactly like whispertranscriber/demucs). The
sampling property surface mirrors the reference (temp, top-k, top-p,
seed, history-size, max-tokens).

The port's copy of gstpu/elements/text/llm.py, with the model and the
prompt's token ids on the port's default device (`gstpu_torch.init`),
run there with TF32 off; the tokenizer stays on the host.
`torch.manual_seed` seeds the CPU's generator and every CUDA device's.

A model-path that holds a config.json of `model_type: deepseek_v3` and
no weights runs the port's own model (gstpu_torch/models/deepseek_v3.py,
`PortLm`) with weights drawn from `seed`, shared by every element that
names the same directory and seed. It decodes greedily (temp=0). With no
tokenizer files it departs from the reference's tokenizer: a prompt's
UTF-8 bytes are its ids 0-255, and each generated id goes out as one
printable byte (id mod 95 + 32), so a reply of n tokens reads back as n
tokens in the next prompt's history. With `context`, every element of
the named DeviceContext submits its prompt and one fire serves them all
in one batched prefill and decode loop; each reply keeps its input's
pts and duration.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element
from gstpu_torch.runtime.device_batch import DeviceContext

TEXT_CAPS = Caps.new("text/x-raw", format="utf8")


class TransformersLm:
    """Engine on transformers AutoModelForCausalLM."""

    def __init__(self, model_path: str, *, temp: float, top_k: int,
                 top_p: float, seed: int, max_tokens: int):
        import torch
        from transformers import (AutoModelForCausalLM,
                                  AutoTokenizer)

        from gstpu_torch.core.device import default_device
        self.tok = AutoTokenizer.from_pretrained(
            model_path, local_files_only=True)
        self.device = default_device()
        self.model = AutoModelForCausalLM.from_pretrained(
            model_path, local_files_only=True).eval().to(self.device)
        self.temp = temp
        self.top_k = top_k
        self.top_p = top_p
        self.max_tokens = max_tokens
        torch.manual_seed(seed)

    def generate(self, prompt: str) -> str:
        import torch

        from gstpu_torch.core.device import tf32_off
        ids = self.tok(prompt, return_tensors="pt").input_ids.to(
            self.device)
        do_sample = self.temp > 0
        with torch.no_grad(), tf32_off():
            out = self.model.generate(
                ids, max_new_tokens=self.max_tokens,
                do_sample=do_sample,
                temperature=self.temp if do_sample else None,
                top_k=self.top_k if do_sample else None,
                top_p=self.top_p if do_sample else None,
                pad_token_id=self.tok.eos_token_id)
        return self.tok.decode(out[0][ids.shape[1]:].cpu(),
                               skip_special_tokens=True).strip()


class PortLm:
    """Engine on the port's deepseek_v3 model for a config-only
    directory, with the byte tokenizer."""

    def __init__(self, model_path: str, config: dict, *, seed: int,
                 max_tokens: int):
        from gstpu_torch.core.device import default_device
        from gstpu_torch.models.deepseek_v3 import DeepseekV3Lm
        self.model = DeepseekV3Lm.load(model_path, config, seed,
                                       default_device())
        self.max_tokens = max_tokens

    @staticmethod
    def encode(prompt: str) -> np.ndarray:
        return np.frombuffer(prompt.encode("utf-8"), np.uint8)

    @staticmethod
    def decode(ids) -> str:
        return bytes(i % 95 + 32 for i in ids).decode("ascii")

    def serve(self, requests: list) -> list:
        """One fire: a reply to each LmRequest, in order."""
        gen = self.model.generate(
            [r.ids for r in requests], self.max_tokens,
            keep=[i for i, r in enumerate(requests) if r.keep])
        return [LmReply(self.decode(ids), r.ids, ids, gen.logits.get(i),
                        gen.routes.get(i))
                for i, (r, ids) in enumerate(zip(requests, gen.ids))]

    def generate(self, prompt: str) -> str:
        return self.serve([LmRequest(self.encode(prompt))])[0].text


@dataclass
class LmRequest:
    """A prompt's ids; `keep` asks for the reply's logits."""
    ids: np.ndarray
    keep: bool = False


@dataclass
class LmReply:
    """A reply's text, the prompt and generated ids, and where asked
    the logits (max_tokens, vocab) that chose them and the experts chosen
    at each position (see deepseek_v3.Generation)."""
    text: str
    prompt_ids: np.ndarray
    ids: list
    logits: object = None
    routes: object = None


@register_element("llamatexttransform", Rank.NONE)
class LlamaTextTransform(BaseTransform):
    PAD_TEMPLATES = [
        PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                    TEXT_CAPS.copy()),
        PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                    TEXT_CAPS.copy()),
    ]

    model_path = Property(str, default=None, mutable=Mutability.READY,
                          blurb="Local causal-LM directory "
                                "(transformers format)")
    system_prompt = Property(str, default=None,
                             mutable=Mutability.READY)
    history_size = Property(int, default=4, minimum=0, maximum=64,
                            mutable=Mutability.READY,
                            blurb="Prior exchanges kept in the "
                                  "prompt (reference history-size)")
    max_tokens = Property(int, default=64, minimum=1, maximum=4096,
                          mutable=Mutability.READY)
    temp = Property(float, default=0.8, minimum=0.0, maximum=4.0,
                    mutable=Mutability.READY)
    top_k = Property(int, default=40, minimum=0, maximum=1000,
                     mutable=Mutability.READY)
    top_p = Property(float, default=0.95, minimum=0.0, maximum=1.0,
                     mutable=Mutability.READY)
    seed = Property(int, default=0, minimum=0,
                    mutable=Mutability.READY)
    context = Property(str, default=None, mutable=Mutability.READY,
                       blurb="DeviceContext name: the prompts of every "
                             "member run as one batched prefill and "
                             "decode (the port's config-only models)")

    # test/app hook: callable str -> str replacing the LM
    engine = None
    # test/benchmark hook: keep each reply's LmReply (ids and logits)
    # in `last_reply` (the port's model in a context)
    keep_logits = False

    def __init__(self, name=None):
        super().__init__(name)
        self._history: list[tuple[str, str]] = []
        self._lm: PortLm | None = None
        self._ctx = None
        self._asked: deque = deque()
        self.last_reply: LmReply | None = None

    def transform_caps(self, direction, caps, filter):
        out = TEXT_CAPS.copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def start(self) -> bool:
        self._history = []
        self._asked.clear()
        if self.engine is None and self.model_path:
            from gstpu_torch.models.deepseek_v3 import config_only
            try:
                cfg = config_only(self.model_path)
                if cfg is not None:
                    return self._start_port(cfg)
            except (OSError, ValueError, RuntimeError) as e:
                self.post_error(f"llamatexttransform: cannot load "
                                f"{self.model_path!r}: {e}")
                return False
        if self.context:
            self.post_error("llamatexttransform: context batching needs "
                            "a config-only deepseek_v3 model-path")
            return False
        if self.engine is None:
            if not self.model_path:
                self.post_error("llamatexttransform: no model-path "
                                "and no engine injected")
                return False
            try:
                lm = TransformersLm(self.model_path, temp=self.temp,
                                    top_k=self.top_k,
                                    top_p=self.top_p, seed=self.seed,
                                    max_tokens=self.max_tokens)
                self.engine = lm.generate
            except Exception as e:
                self.post_error(f"llamatexttransform: cannot load "
                                f"{self.model_path!r}: {e}")
                return False
        return True

    def _start_port(self, cfg: dict) -> bool:
        if self.temp > 0:
            self.post_error("llamatexttransform: the port's model "
                            "decodes greedily: set temp=0")
            return False
        self._lm = PortLm(self.model_path, cfg, seed=self.seed,
                          max_tokens=self.max_tokens)
        if self.context:
            self._ctx = DeviceContext.acquire(self.context, block=1)
            self._ctx.finalize_member(self)
        else:
            self.engine = self._lm.generate
        return True

    def stop(self) -> bool:
        if self._ctx is not None:
            self._ctx.remove_member(self)
            self._ctx = None
        if self._lm is not None:
            if self.engine == self._lm.generate:
                self.engine = None
            self._lm = None
        return super().stop()

    # -- DeviceContext contract (ragged: one prompt an item) ------------
    def device_batch_spec(self) -> dict:
        lm = self._lm
        return dict(key=("llamatexttransform", id(lm.model),
                         lm.max_tokens),
                    ragged=True, step=lm.serve,
                    init_state=lambda: (), uniforms=lambda: ())

    def make_batch_buffer(self, reply: LmReply, pts, dur) -> Buffer:
        self._history.append((self._asked.popleft(), reply.text))
        if self.keep_logits:
            self.last_reply = reply
        return Buffer(reply.text.encode("utf-8"), pts=pts, duration=dur)

    def drain(self) -> list:
        if self._ctx is not None:
            return self._ctx.flush_member(self)
        return []

    def _prompt(self, text: str) -> str:
        parts = []
        if self.system_prompt:
            parts.append(self.system_prompt)
        for q, a in self._history[-self.history_size:]:
            parts.append(f"User: {q}\nAssistant: {a}")
        parts.append(f"User: {text}\nAssistant:")
        return "\n".join(parts)

    def transform(self, buf: Buffer) -> Buffer | None:
        text = buf.to_bytes().decode("utf-8", "replace").strip()
        if not text:
            return None
        if self._ctx is not None:
            self._asked.append(text)
            self._ctx.submit_item(
                self, LmRequest(self._lm.encode(self._prompt(text)),
                                self.keep_logits), buf.pts, buf.duration)
            return []                 # replies flow from the fire
        try:
            reply = self.engine(self._prompt(text))
        except Exception as e:
            self.post_error(f"llamatexttransform: engine failed: {e}")
            return None
        self._history.append((text, reply))
        return Buffer(reply.encode("utf-8"), pts=buf.pts,
                      duration=buf.duration)
