"""Conversation-memory block assembly.

Parity with reference api/app.py:509-523 + api/routes/chat.py:160-164:
rolling thread summary (re-summarized to <=400 chars) + recent messages
(re-summarized to <=200 chars each) as <<<HISTORY_SUMMARY>>> /
<<<HISTORY_RECENT>>> blocks; after each reply the summary is regenerated
from "Previous summary + New exchange".
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from tpu_rag_torch.compose.summarize import Summarizer
from tpu_rag_torch.memory.db import ConversationDB


def format_history_block(db: ConversationDB, summarizer: Summarizer,
                         thread_id: str, language: str | None,
                         max_turns: int = 6, max_chars: int = 1200) -> str:
    recent = db.load_recent_messages(thread_id, max_turns=max_turns, max_chars=max_chars)
    summ = db.get_summary(thread_id)
    parts: list[str] = []
    # cache-miss summarizations are LLM round-trips: run the summary and
    # every recent message concurrently (same latency fix as
    # summarize.build_context) instead of up to 1 + max_turns sequential
    # calls on the compose hot path
    with ThreadPoolExecutor(max_workers=4) as ex:
        summ_f = (ex.submit(summarizer.summarize_chunk, summ, language,
                            max_chars_per_chunk=400) if summ else None)
        recent_f = [ex.submit(summarizer.summarize_chunk, content, language,
                              max_chars_per_chunk=200)
                    for _role, content in recent] if recent else []
        if summ_f is not None:
            parts.append(f"<<<HISTORY_SUMMARY>>>\n{summ_f.result()}\n"
                         f"<<<END_HISTORY_SUMMARY>>>")
        if recent:
            lines = []
            for (role, _content), f in zip(recent, recent_f):
                tag = "U" if role == "user" else "A"
                lines.append(f"{tag}: {f.result()}")
            parts.append("<<<HISTORY_RECENT>>>\n" + "\n".join(lines)
                         + "\n<<<END_HISTORY_RECENT>>>")
    return "\n\n".join(parts) if parts else ""


def update_thread_summary(db: ConversationDB, summarizer: Summarizer,
                          thread_id: str, query: str, draft: str,
                          lang: str | None) -> None:
    prev = db.get_summary(thread_id)
    if summarizer.mode == "off":
        # no LLM available by design: keep a rolling TAIL of plain
        # exchanges.  Head-truncating the scaffold froze the summary once
        # it reached the cap and nested "Previous summary:" labels into
        # every later prompt.
        rolled = f"{prev}\nU: {query}\nA: {draft}".strip() if prev else \
            f"U: {query}\nA: {draft}"
        db.set_summary(thread_id, rolled[-800:], lang)
        return
    update_src = f"Previous summary:\n{prev}\n\nNew exchange:\nU: {query}\nA: {draft}\n"
    new_summary = summarizer.summarize_chunk(update_src, lang, max_chars_per_chunk=800)
    if new_summary:
        db.set_summary(thread_id, new_summary, lang)
