"""Chat templates rendered as transformers renders them.

transformers' apply_chat_template compiles a tokenizer's Jinja template in
an `ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True)`
with the loopcontrols extension, its own `tojson` filter (no HTML
escaping) and the globals `raise_exception` and `strftime_now`, and passes
the messages, `add_generation_prompt`, the tools and documents and the
tokenizer's special tokens (bos_token, eos_token, ...) as variables. The
same here (without tools and documents), for multimodal/hf_tokenizer.py.
"""

from __future__ import annotations

import functools
import json
from datetime import datetime


@functools.lru_cache(maxsize=32)
def compile_template(source: str):
    try:
        import jinja2
        import jinja2.ext
        from jinja2.sandbox import ImmutableSandboxedEnvironment
    except ImportError as e:
        raise ImportError("rendering a chat template needs jinja2 (a "
                          "requirement of torch's own package)") from e

    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    def tojson(x, ensure_ascii=False, indent=None, separators=None,
               sort_keys=False):
        return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                          separators=separators, sort_keys=sort_keys)

    def strftime_now(fmt):
        return datetime.now().strftime(fmt)

    env = ImmutableSandboxedEnvironment(
        trim_blocks=True, lstrip_blocks=True,
        extensions=[jinja2.ext.loopcontrols])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = strftime_now
    return env.from_string(source)


def render(source: str, messages, add_generation_prompt: bool = False,
           **variables) -> str:
    """One conversation through the template `source`."""
    return compile_template(source).render(
        messages=messages, add_generation_prompt=add_generation_prompt,
        **variables)
