"""The serving engine over more than one rank: rank 0 decides, every rank
runs the same index calls.

The reference's engine runs under any mesh, since JAX has one controller.
Here each rank is a process with its own clock, so ranks left to
themselves would form different waves and enter different collectives.
Instead rank 0 keeps the engine's clock and every decision (waves,
injected faults, retries and bisection, the poison search, the canary
probes and restores of `_maintain`), and before each index call that can
enter a collective it broadcasts an order over the world group
(`send`); the other ranks run `follow`, which executes each order on
their own placed index until the closing order. The closing order carries
rank 0's result, so every rank returns the same one.

The orders, each a tuple:

  (CANDIDATES, q, base, k, alive)  `search_stage_candidates` of the (B, d)
                                   f32 queries q on base graph `base`,
                                   top-k k, over the segments `alive`
                                   (rank 0's serving set, pinned at the
                                   call); stage A of a wave, or a probe
                                   of the poison search
  (RESTORE, seg, directory)        `persist.restore_segment`
  (CANARY, seg, seed)              `canary_probe`
  (CLOSE, result, error)           the end: follow returns `result`, or
                                   raises when rank 0 failed (`error`,
                                   its message; `result` then the
                                   partial results)

Stage B (verification and the delta merge) and the collect run on each
rank's whole rows and enter no collective, so they need no order: the
followers leave them to rank 0. The broadcast is `broadcast_object_list`
on the default group: NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

import torch.distributed as dist

CANDIDATES = "candidates"
RESTORE = "restore"
CANARY = "canary"
CLOSE = "close"


class LeaderFailed(RuntimeError):
    """Raised on a follower when rank 0's call failed; carries rank 0's
    partial results as `partial_results`."""


def on_mesh(index) -> bool:
    """Whether an index is placed over a mesh of ranks (`shard_over`), of
    any size: one rank sends its orders to nobody."""
    rt = getattr(getattr(index, "index", index), "_rt", None)
    return rt is not None and rt.distributed


def send(order: tuple) -> None:
    """Rank 0: broadcast one order."""
    dist.broadcast_object_list([order], src=0)


def receive() -> tuple:
    box = [None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def follow(index):
    """Run rank 0's orders on this rank's index until the closing order;
    return the result it carries."""
    from repro_torch.index.persist import restore_segment

    while True:
        order = receive()
        kind = order[0]
        if kind == CANDIDATES:
            _, q, base, k, alive = order
            index.search_stage_candidates(q, base, k=k, alive=alive)
        elif kind == RESTORE:
            restore_segment(index, order[1], order[2])
        elif kind == CANARY:
            index.canary_probe(order[1], seed=order[2])
        elif kind == CLOSE:
            _, result, error = order
            if error is not None:
                e = LeaderFailed(f"rank 0 failed: {error}")
                e.partial_results = result
                raise e
            return result
        else:
            raise ValueError(f"unknown order {kind!r}")


def lead(fn, index, set_orders):
    """fn() on every rank of `index`'s mesh: run by rank 0 with its orders
    sent (`set_orders(send)` installs the sender where fn's index calls
    pass, `set_orders(None)` removes it), followed by the others. Every
    rank returns rank 0's result. Off a mesh, fn() itself."""
    if not on_mesh(index):
        return fn()
    if dist.get_rank() != 0:
        return follow(index)
    result, error = None, None
    set_orders(send)
    try:
        result = fn()
        return result
    except Exception as e:
        result = getattr(e, "partial_results", None)
        error = f"{type(e).__name__}: {e}"
        raise
    finally:
        set_orders(None)
        send((CLOSE, result, error))
