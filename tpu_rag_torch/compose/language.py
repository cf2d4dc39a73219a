"""Language normalization, per-language output policy, user-content templates.

Behavior parity with the reference's language subsystem (reference
api/app.py:374-465): BCP-47-ish tags normalize onto
{zh-tw, zh-cn, ja, ko, en, fr, de, es}; each language gets a (user-guard,
system-guard) enforcement pair; user content is guard + <<<HISTORY+RAG
CONTEXT>>>-wrapped context + a per-language task body.  Guard wording is
original but preserves the reference's rules (answer only in the target
language; proper nouns may stay English; paraphrase quotes; code may be
English, explanations must not be).
"""

from __future__ import annotations

_LANG_ALIASES = {
    # bare "zh" maps to the traditional default: it exists in no policy or
    # template table, so leaving it unmapped silently served the English
    # fallback guard to the most common Chinese language tag
    "zh": "zh-tw",
    "zh-hant": "zh-tw", "zh-tw": "zh-tw", "zh-hk": "zh-tw", "zh-mo": "zh-tw",
    "zh-hans": "zh-cn", "zh-cn": "zh-cn", "zh-sg": "zh-cn",
    "ja": "ja", "ja-jp": "ja",
    "ko": "ko", "ko-kr": "ko",
    "en": "en", "en-us": "en", "en-gb": "en",
    "fr": "fr", "de": "de", "es": "es",
}


def norm_lang(lang: str | None, default: str = "zh-tw") -> str:
    l = (lang or "").strip().lower().replace("_", "-")
    if not l:
        return (default or "zh-tw").lower()
    return _LANG_ALIASES.get(l, l)


_POLICIES: dict[str, tuple[str, str]] = {
    "zh-tw": (
        "【語言規則】請全程以繁體中文（台灣用語）回答。英文專有名詞可以保留原文，"
        "但不可出現完整的英文句子；若引用英文資料，請改以繁體中文轉述。"
        "程式碼與指令可保留英文，說明文字一律使用繁體中文。",
        "嚴格執行語言規則：輸出只能是繁體中文，禁止英文或簡體中文句子；"
        "專有名詞可用英文但不得組成英文句；引用內容必須以繁體中文轉述。",
    ),
    "zh-cn": (
        "【语言规则】请全程使用简体中文回答。英文专有名词可以保留，"
        "但不可出现完整英文句子；引用英文资料时请用简体中文转述。"
        "代码与命令可以保留英文，说明文字必须是简体中文。",
        "严格执行语言规则：输出只能是简体中文，禁止英文句子；"
        "专有名词可用英文但不得组成英文句；引用内容必须用中文转述。",
    ),
    "ja": (
        "【言語ルール】回答はすべて日本語で書いてください。固有名詞は英語表記のままで"
        "構いませんが、完全な英文は書かないでください。英語の引用は日本語に要約して"
        "ください。コードやコマンドは英語のままで良いですが、説明は日本語で。",
        "言語ルールを厳守してください：日本語のみで出力し、英文は禁止。"
        "固有名詞の英語表記は可、引用は日本語で要約すること。",
    ),
    "ko": (
        "【언어 규칙】답변은 전부 한국어로 작성하세요. 고유명사는 영어 표기를 유지해도 "
        "되지만 완전한 영어 문장은 쓰지 마세요. 영어 자료를 인용할 때는 한국어로 "
        "요약하세요. 코드와 명령어는 영어 가능, 설명은 반드시 한국어로.",
        "언어 규칙을 엄격히 지키세요: 한국어로만 출력, 영어 문장 금지. "
        "고유명사 영어 표기는 허용, 인용은 한국어 요약으로.",
    ),
    "es": (
        "【Reglas de idioma】Responde solo en español. Los nombres propios pueden "
        "quedar en inglés, pero no escribas oraciones completas en inglés; "
        "parafrasea en español cualquier cita en otro idioma. El código y los "
        "comandos pueden ir en inglés; las explicaciones, en español.",
        "Cumple estrictamente las reglas de idioma: solo español; "
        "nada de oraciones en otros idiomas; parafrasea las citas en español.",
    ),
    "de": (
        "【Sprachregeln】Antworte ausschließlich auf Deutsch. Eigennamen dürfen "
        "englisch bleiben, aber bilde keine vollständigen englischen Sätze; "
        "paraphrasiere fremdsprachige Zitate auf Deutsch. Code und Befehle dürfen "
        "englisch sein, Erklärungen müssen deutsch sein.",
        "Halte die Sprachregeln strikt ein: nur Deutsch; keine Sätze in anderen "
        "Sprachen; Zitate auf Deutsch paraphrasieren.",
    ),
    "fr": (
        "【Règles linguistiques】Répondez uniquement en français. Les noms propres "
        "peuvent rester en anglais, mais n'écrivez pas de phrases complètes en "
        "anglais ; reformulez en français toute citation d'une autre langue. "
        "Le code et les commandes peuvent rester en anglais ; les explications "
        "doivent être en français.",
        "Respectez strictement les règles linguistiques : uniquement le français ; "
        "aucune phrase dans une autre langue ; reformulez les citations en français.",
    ),
    "en": (
        "Use ONLY English. Proper nouns may keep their original form. "
        "Summarize any non-English quotations in English. Code and commands may "
        "be in any language; explanatory text must be English.",
        "Strictly English only. Do not output sentences in other languages. "
        "Proper nouns are allowed; quotes must be summarized in English.",
    ),
}

_FALLBACK_POLICY = (
    "Respond ONLY in the requested language. Proper nouns may keep their "
    "original form. If quoting other languages, summarize them in the "
    "requested language.",
    "Strictly respond ONLY in the requested language. Do not switch languages.",
)


def language_policy(lang: str | None, default: str = "zh-tw") -> tuple[str, str]:
    """-> (user_guard, system_guard) for the normalized language."""
    l = norm_lang(lang, default)
    policy = _POLICIES.get(l)
    if policy is not None:
        return policy
    # name the language in the fallback guard: "the requested language"
    # gave the model nothing to anchor on
    return tuple(g.replace("the requested language", f"the language with tag '{l}'")
                 for g in _FALLBACK_POLICY)


def wrap_context(context: str) -> str:
    return f"<<<HISTORY+RAG CONTEXT>>>\n{context}\n<<<END>>>"


_TEMPLATES = {
    "zh-tw": {"guide": "字數約 {target_length}。",
              "body": "請根據上述內容完成「{query}」。{guide}\n輸出可用段落或條列，務必遵守語言規則。"},
    "zh-cn": {"guide": "字数约 {target_length}。",
              "body": "请根据上述内容完成“{query}”。{guide}\n输出可以使用段落或项目符号，务必遵守语言规则。"},
    "ja": {"guide": "目安の長さ: {target_length}。",
           "body": "上記の内容に基づいて「{query}」を完成してください。{guide}\n段落または箇条書き可。言語ルールを必ず守ってください。"},
    "ko": {"guide": " 분량: 약 {target_length}자.",
           "body": "위 내용을 바탕으로 ‘{query}’를 완성하세요.{guide}\n단락 또는 불릿 허용. 언어 규칙을 반드시 준수하세요."},
    "fr": {"guide": " Longueur cible : {target_length}.",
           "body": "Complétez « {query} » en vous basant sur le contexte ci-dessus.{guide}\nUtilisez des paragraphes et/ou des puces."},
    "es": {"guide": " Longitud objetivo: {target_length}.",
           "body": "Complete “{query}” basándose en el contexto anterior.{guide}\nUse párrafos y/o viñetas."},
    "de": {"guide": " Zielumfang: {target_length}.",
           "body": "Vervollständige „{query}“ basierend auf dem obigen Kontext.{guide}\nVerwende Absätze und/oder Aufzählungspunkte."},
    "en": {"guide": " Target length: {target_length}.",
           "body": "Complete “{query}” based on the context above.{guide}\nUse paragraphs and/or bullet points."},
}


def build_user_content(query: str, context: str, lang: str | None,
                       target_length: str | None, user_guard: str,
                       default: str = "zh-tw") -> str:
    l = norm_lang(lang, default)
    tpl = _TEMPLATES.get(l, _TEMPLATES["en"])
    guide = tpl["guide"].format(target_length=target_length) if target_length else ""
    body = tpl["body"].format(query=query, guide=guide)
    return f"{user_guard}\n{wrap_context(context)}\n{body}"
