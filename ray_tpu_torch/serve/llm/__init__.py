"""LLM serving engine of the port: continuous batching over an arena-paged
KV cache with prefix reuse (see ``engine``), GPT-2 on the card (``model``).

As in the reference (``ray_tpu/serve/llm``): ``engine.SequenceScheduler``
admits sequences at decode-step boundaries with KV-budget admission that
sheds 503s; ``kv_cache.KVPool`` pages the KV cache into slab-arena entries
leased from the node's raylet (heap pages with no cluster); ``prefix``
gives the prefix identity the replica's cache and the handle's affinity
router both hash with. ``LLMServer`` is the deployable ingress.
"""

from ray_tpu_torch.serve.llm.engine import LLMServer, SequenceScheduler
from ray_tpu_torch.serve.llm.kv_cache import (
    KV_PAGE_OID_PREFIX,
    KVPage,
    KVPool,
    PrefixCache,
)
from ray_tpu_torch.serve.llm.model import GPT2LLM, SyntheticLLM, load_model
from ray_tpu_torch.serve.llm.prefix import chain_hashes, longest_match_depth

__all__ = [
    "GPT2LLM",
    "KVPage",
    "KVPool",
    "KV_PAGE_OID_PREFIX",
    "LLMServer",
    "PrefixCache",
    "SequenceScheduler",
    "SyntheticLLM",
    "chain_hashes",
    "load_model",
    "longest_match_depth",
]
