"""LLM serving engine of the port: continuous batching over a paged KV
cache with prefix reuse (see ``engine``), GPT-2 on the card (``model``)."""

from ray_tpu_torch.serve.llm.engine import LLMServer, SequenceScheduler
from ray_tpu_torch.serve.llm.kv_cache import KVPage, KVPool, PrefixCache
from ray_tpu_torch.serve.llm.model import GPT2LLM, SyntheticLLM, load_model
from ray_tpu_torch.serve.llm.prefix import chain_hashes, longest_match_depth

__all__ = [
    "GPT2LLM",
    "KVPage",
    "KVPool",
    "LLMServer",
    "PrefixCache",
    "SequenceScheduler",
    "SyntheticLLM",
    "chain_hashes",
    "load_model",
    "longest_match_depth",
]
