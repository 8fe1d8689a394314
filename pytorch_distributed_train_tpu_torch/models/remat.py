"""Rematerialisation: the JAX package's ``models/remat.py`` for policy
"full" (recompute the whole block in backward), as
``torch.utils.checkpoint`` without re-entry. The other policies keep chosen
intermediates and are not ported."""

from __future__ import annotations

from torch.utils.checkpoint import checkpoint

POLICIES = ("full",)


def check_policy(policy: str) -> None:
    if policy not in POLICIES:
        raise NotImplementedError(
            f"remat_policy {policy!r} is not ported to the PyTorch package "
            f"yet; it has {list(POLICIES)}")


def remat_call(block, *args):
    """``block(*args)`` with its activations recomputed in backward."""
    return checkpoint(block, *args, use_reentrant=False)
