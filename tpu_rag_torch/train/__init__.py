from tpu_rag_torch.train.contrastive import (ContrastiveTrainer, info_nce_loss,
                                             warmup_cosine_decay)

__all__ = ["ContrastiveTrainer", "info_nce_loss", "warmup_cosine_decay"]
