from tpu_rag_torch.compose.language import build_user_content, language_policy, norm_lang, wrap_context
from tpu_rag_torch.compose.prompts import CREATIVE_SYS, STRICT_SYS, prepare_messages
from tpu_rag_torch.compose.style import style_temperature, style_to_controller
from tpu_rag_torch.compose.think import ThinkFolder

__all__ = [
    "norm_lang",
    "language_policy",
    "build_user_content",
    "wrap_context",
    "STRICT_SYS",
    "CREATIVE_SYS",
    "prepare_messages",
    "style_to_controller",
    "style_temperature",
    "ThinkFolder",
]
