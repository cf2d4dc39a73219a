from tpu_rag_torch.llm.dispatch import LLMDispatcher

__all__ = ["LLMDispatcher"]
