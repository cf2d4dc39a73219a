from tpu_rag_torch.memory.db import ConversationDB

__all__ = ["ConversationDB"]
