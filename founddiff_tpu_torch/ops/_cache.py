"""Host-side helpers of the kernel wrappers: whether a call needs autograd,
and weight operands derived once per parameter version.

A wrapper's weight operands (io-dtype casts, fp32 copies, folded or
concatenated projections) depend only on parameters, so serving derives
them once.  :func:`derived` keys a value on its source tensors: each
source's root tensor (a parameter, for a view of one), data pointer, shape,
strides, dtype and ``_version``.  An in-place update (an optimizer step, an
EMA update, ``load_state_dict``'s ``copy_``) bumps the version, and a
``.data`` swap moves the pointer, so the next call derives the value anew.
The value is kept beside the first source's root tensor and goes with it.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on these tensors (``None`` skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _root(t: torch.Tensor) -> torch.Tensor:
    return t if t._base is None else t._base


# id(root) -> (weak reference to root, {key: entry}); an entry goes when its
# root dies, and nothing is set on the tensors, so they pickle as before
_STORE: Dict[int, Tuple[weakref.ref, dict]] = {}


def _entries(root: torch.Tensor) -> dict:
    k = id(root)
    hit = _STORE.get(k)
    if hit is not None and hit[0]() is root:
        return hit[1]

    def drop(ref, k=k, store=_STORE):
        if store.get(k, (None,))[0] is ref:
            del store[k]

    entries = {}
    _STORE[k] = (weakref.ref(root, drop), entries)
    return entries


def derived(tag, sources: Sequence[torch.Tensor], make: Callable):
    """``make()``, computed once per version of ``sources`` and ``tag``.  A
    first source with autograd history is an activation of a recorded call:
    then ``make()`` runs on each call and nothing is kept."""
    first = _root(sources[0])
    if first.grad_fn is not None:
        return make()
    try:  # each source's geometry (data pointer, shape, strides, dtype) and version
        sig = tuple((t.data_ptr(), t.shape, t.stride(), t.dtype, t._version) for t in sources)
    except RuntimeError:  # an inference tensor keeps no version to key on
        return make()
    store = _entries(first)
    # one entry per tag and view of the first source: a miss replaces it
    key = (tag, sig[0][:4])
    hit = store.get(key)
    # the other roots still the same tensors (``_root`` inlined: every direct call's path)
    if hit is not None and hit[0] == sig and all(
            r() is (t if t._base is None else t._base) for r, t in zip(hit[1], sources[1:])):
        return hit[2]
    value = make()
    store[key] = (sig, [weakref.ref(_root(t)) for t in sources[1:]], value)
    return value


def f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """t as a contiguous fp32 tensor without autograd history (``None``
    stays ``None``); a copy is derived once per version of t."""
    if t is None:
        return None
    if t.dtype == torch.float32 and t.is_contiguous():
        return t.detach()
    return derived("f32", (t,), lambda: t.detach().float().contiguous())
