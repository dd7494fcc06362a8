"""Prefix identity: block hash chains shared by cache and router.

A prompt's first ``k`` full blocks of ``block_tokens`` tokens are named
by a hash CHAIN — ``h_i = H(h_{i-1} || tokens[block_i])`` — so a chain
value identifies the whole prefix up to that block, not just the block's
own tokens (two prompts sharing block 3 but not block 0 must not
collide). This is the radix-tree identity vLLM-style prefix caches key
on, flattened to hashes so it can ride a controller load report.

Deliberately dependency-free: the handle-side affinity router imports
this without pulling numpy or the engine.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Iterable, List, Sequence, Set

# bump when the chain format changes: a router matching against a
# replica's digest must never cross-match incompatible hash versions
CHAIN_VERSION = b"rtpu-kv1"


def block_chain(prev: bytes, tokens: Sequence[int]) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(prev)
    h.update(struct.pack(f"<{len(tokens)}q", *[int(t) for t in tokens]))
    return h.digest()


def chain_hashes(tokens: Sequence[int], block_tokens: int) -> List[str]:
    """Hex chain values for every FULL block of ``tokens``. The partial
    tail block has no stable identity (it is still being written) and is
    excluded on both sides."""
    if block_tokens <= 0:
        return []
    out: List[str] = []
    prev = CHAIN_VERSION
    for i in range(len(tokens) // block_tokens):
        prev = block_chain(prev, tokens[i * block_tokens:(i + 1) * block_tokens])
        out.append(prev.hex())
    return out


def longest_match_depth(chains: Sequence[str], held: Set[str]) -> int:
    """How many leading blocks of ``chains`` a replica's digest covers.
    Chains nest (block i's value commits to blocks 0..i), so the first
    miss ends the match — a deeper stray hit would be a hash collision,
    not a shared prefix."""
    depth = 0
    for c in chains:
        if c not in held:
            break
        depth += 1
    return depth


def tokenize(prompt: str, vocab: int = 50_000) -> List[int]:
    """Whitespace 'tokenizer' for the synthetic model: stable across
    processes (builtin ``hash`` is salted per interpreter — the router
    and the replica must derive the SAME token ids from a prompt or
    prefix chains would never match)."""
    out: List[int] = []
    for w in prompt.split():
        d = hashlib.blake2b(w.encode("utf-8", "replace"),
                            digest_size=4).digest()
        out.append(int.from_bytes(d, "little") % vocab)
    return out


def extract_tokens(args: Sequence, kwargs: dict) -> List[int]:
    """Best-effort prompt-token extraction from a serve call's
    arguments (HTTP Request envelope or direct handle call) — the
    affinity router's view of the request. Returns [] when the shape is
    not LLM-like; the router then falls back to plain p2c."""
    body = None
    if "tokens" in kwargs:
        body = {"tokens": kwargs["tokens"]}
    elif "prompt" in kwargs:
        body = {"prompt": kwargs["prompt"]}
    elif args:
        a = args[0]
        if isinstance(a, dict):
            body = a
        elif hasattr(a, "body"):  # serve Request envelope
            try:
                import json

                body = json.loads(a.body or b"null")
            except Exception:
                return []
    if not isinstance(body, dict):
        return []
    try:
        if body.get("tokens") is not None:
            return [int(t) for t in body["tokens"]]
        if body.get("prompt"):
            return tokenize(body["prompt"])
    except Exception:
        return []
    return []


def digest(chains: Iterable[str], cap: int) -> List[str]:
    """Bound a replica's reported prefix digest: newest-inserted wins is
    the caller's job (it passes an ordered iterable); this just caps the
    wire size of the load report."""
    out = list(chains)
    return out[-cap:] if cap > 0 else out
