"""Style controller: tone -> system-prompt block + temperature policy.

Parity with reference api/app.py:156-187: StyleSpec fields
{tone, directness, empathy, hedging, formality} produce a "tone controller"
system block and a per-tone temperature (playful 0.8, teacher 0.6,
expert 0.35, journalistic 0.45, neutral=base) nudged by hedging.
"""

from __future__ import annotations


def clamp(x, lo: float = 0.0, hi: float = 1.0) -> float:
    try:
        return max(lo, min(hi, float(x)))
    except (TypeError, ValueError):
        return 0.0


def style_to_controller(style: dict | None) -> str:
    if not style:
        return ""
    tone = (style.get("tone") or "neutral").lower()
    d = clamp(style.get("directness"))
    e = clamp(style.get("empathy"))
    h = clamp(style.get("hedging"))
    f = clamp(style.get("formality"))
    return (
        "【語氣控制器】\n"
        f"- tone: {tone}\n- directness: {d:.2f}\n- empathy: {e:.2f}\n"
        f"- hedging: {h:.2f}\n- formality: {f:.2f}\n"
        "寫作規則：依使用者語言回覆；工程情境先結論後步驟；教學先共情一句再分步；"
        "拒絕時透明原因並提供至少兩個安全替代。"
    )


_TONE_TEMPERATURE = {
    "playful": 0.8,
    "teacher": 0.6,
    "expert": 0.35,
    "journalistic": 0.45,
}


def style_temperature(style: dict | None, base: float = 0.4) -> float:
    if not style:
        return base
    tone = (style.get("tone") or "").lower()
    t = _TONE_TEMPERATURE.get(tone, base)
    # hedging above 0.3 makes output more exploratory, below more fixed
    try:
        t = max(0.1, min(1.0, t + (float(style.get("hedging", 0)) - 0.3) * 0.2))
    except (TypeError, ValueError):
        pass
    return t
