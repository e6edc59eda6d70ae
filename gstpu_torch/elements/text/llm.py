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
"""

from __future__ import annotations

from gstpu_torch.core.base import BaseTransform
from gstpu_torch.core.buffer import Buffer
from gstpu_torch.core.caps import Caps
from gstpu_torch.core.element import PadDirection, PadPresence, PadTemplate
from gstpu_torch.core.props import Mutability, Property
from gstpu_torch.core.registry import Rank, register_element

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

    # test/app hook: callable str -> str replacing the LM
    engine = None

    def __init__(self, name=None):
        super().__init__(name)
        self._history: list[tuple[str, str]] = []

    def transform_caps(self, direction, caps, filter):
        out = TEXT_CAPS.copy()
        if filter is not None:
            out = filter.intersect(out)
        return out

    def start(self) -> bool:
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
        self._history = []
        return True

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
        try:
            reply = self.engine(self._prompt(text))
        except Exception as e:
            self.post_error(f"llamatexttransform: engine failed: {e}")
            return None
        self._history.append((text, reply))
        return Buffer(reply.encode("utf-8"), pts=buf.pts,
                      duration=buf.duration)
