"""System prompts + message assembly.

Parity with reference api/app.py:604-639: mode "strict" -> Data-Curator
prompt (context-only), anything else -> Author's-Assistant prompt; messages =
[base system, language system-guard, optional tone controller, user content];
temperature derives from style with base 0.4.
"""

from __future__ import annotations

from tpu_rag_torch.compose.language import build_user_content, language_policy
from tpu_rag_torch.compose.style import style_temperature, style_to_controller

STRICT_SYS = (
    "You are the Data Curator for 'Game Fantasy Edition'. "
    "Rely only on the provided context. If information is missing, list the exact nodes/fields needed. "
    "Do not speculate or invent facts. Keep responses clear and structured."
)
CREATIVE_SYS = (
    "You are the Author's Assistant for 'Game Fantasy Edition'. "
    "Write helpful, clear content grounded in the provided context. "
    "You may extend details only when they do not contradict the context. "
    "Avoid hallucinations; prefer concise paragraphs or bullet points."
)


def prepare_messages(
    query: str,
    context: str,
    mode: str,
    language: str | None,
    target_length: str | None = None,
    style: dict | None = None,
    default_language: str = "zh-tw",
) -> tuple[list[dict], float]:
    sys_base = STRICT_SYS if (mode or "").lower() == "strict" else CREATIVE_SYS
    user_guard, system_guard = language_policy(language, default_language)
    user_content = build_user_content(query, context, language, target_length,
                                      user_guard, default_language)
    style_dict = dict(style) if style else {}
    tone_ctrl = style_to_controller(style_dict)
    temperature = style_temperature(style_dict, base=0.4)
    messages = [
        {"role": "system", "content": sys_base},
        {"role": "system", "content": system_guard},
    ]
    if tone_ctrl:
        messages.append({"role": "system", "content": tone_ctrl})
    messages.append({"role": "user", "content": user_content})
    return messages, temperature


def preview_messages(engine: str, model: str, messages: list, max_len: int = 1200) -> dict:
    """Truncated prompt preview for the SSE debug event
    (reference api/app.py:365-372)."""

    def trunc(val) -> str:
        s = "" if val is None else (val if isinstance(val, str) else str(val))
        if len(s) <= max_len:
            return s
        return s[:max_len] + f"...[+{len(s) - max_len} chars]"

    return {
        "engine": engine,
        "model": model,
        "messages": [{"role": m.get("role"), "content": trunc(m.get("content"))} for m in messages],
    }
