from tpu_rag_torch.utils.env import load_dotenv, env_str, env_int, env_float, env_bool
from tpu_rag_torch.utils.timing import StageTimings

__all__ = [
    "load_dotenv",
    "env_str",
    "env_int",
    "env_float",
    "env_bool",
    "StageTimings",
]
