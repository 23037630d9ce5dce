"""Lockstep across the ranks of a mesh ``QueryService``.

A mesh service runs in every rank's process, each over the full tables,
and every rank makes the same calls (the JAX package has one controller
instead).  Each rank's collectives must then come in the same order on
every rank, and every decision that reads a clock or a disk must be the
same on every rank.  ``Lockstep`` gives a service both:

* **One lane.**  One thread per service, the lane, runs every *step* that
  may issue a collective: a served batch, a table update, a tuning run, an
  async batch claim.  Callers hand their step to the lane and wait for it.
  Each step has a key.  Rank 0 runs its steps in the order they reach it
  and, before each, broadcasts the key (and a payload) over a ``gloo``
  control group; every other rank runs its own step with that key next,
  waiting for a caller to hand it over.  So concurrent sync and async
  callers on one rank are safe, and a step on another rank sees rank 0's
  payload (an async claim names the requests rank 0 claimed).
* **Inside a step.**  ``share(value)`` gives every rank rank 0's value (a
  serve time measured on rank 0's clock, the tuner's winners), and
  ``program(key, run)`` runs one ring program: every rank first shows the
  others the key of the program it is about to run and, after it, whether
  it failed.  A divergence or a failure then raises on every rank at the
  same point, before or after the program, never inside it, so every rank
  takes the same fallback.  A divergence also stops the lane on every
  rank: from then on each step fails at once and sends nothing, since the
  ranks no longer agree on what comes next.

At world size 1 nothing is sent; the lane still runs every step, so one
thread issues all of a NCCL group's work.  A rank that dies inside a ring
program is out of reach here: the process group's timeout turns that hang
into an error.
"""

from __future__ import annotations

import atexit
import threading
import weakref
from typing import Any, Callable

import torch
import torch.distributed as dist

#: seconds a rank other than 0 waits for the step or the request rank 0
#: named before it declares the ranks diverged (the default process-group
#: timeout of ``torch.distributed``)
WAIT_S = 1800.0


#: the lanes alive in this process, closed at exit: a thread that ran
#: torch work must be gone before the interpreter tears torch down
_LANES: "weakref.WeakSet[Lockstep]" = weakref.WeakSet()


@atexit.register
def _close_lanes() -> None:
    for lane in list(_LANES):
        lane.close()
        lane._thread.join(timeout=10.0)


class MeshDivergence(RuntimeError):
    """The ranks of a mesh service did not make the same calls."""


class MeshPeerError(RuntimeError):
    """Another rank failed a step that this rank ran without fault."""


class _Step:
    __slots__ = ("key", "work", "payload", "done", "value", "error")

    def __init__(self, key, work: Callable[[Any], Any], payload):
        self.key = key
        self.work = work
        self.payload = payload
        self.done = threading.Event()
        self.value = None
        self.error: BaseException | None = None


class Lockstep:
    """The lane of one mesh service (see the module docstring).  Made
    after ``init_process_group`` on every rank, in the same order as the
    other groups, with the device the service's collectives use."""

    def __init__(self, device: torch.device):
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        # keys, payloads and failure flags travel on the host
        self._group = dist.new_group(backend="gloo") if self.world > 1 \
            else None
        self._device = torch.device(device)
        self._cv = threading.Condition()
        self._pending: list[_Step] = []
        self._broken: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(target=self._lane,
                                        name="mesh-lockstep", daemon=True)
        self._thread.start()
        _LANES.add(self)

    # ---- caller side -----------------------------------------------------
    def run(self, key, work: Callable[[Any], Any], payload=None):
        """Run ``work(payload)`` on the lane as the step ``key``, in rank
        0's order; on a rank other than 0 ``payload`` is rank 0's.  Blocks
        until the step has run, then returns its value or raises its
        error."""
        step = _Step(key, work, payload)
        with self._cv:
            self._raise_if_broken()
            if self._closed:
                raise RuntimeError("the mesh service's lane is closed")
            self._pending.append(step)
            self._cv.notify_all()
        step.done.wait()
        if step.error is not None:
            raise step.error
        return step.value

    def close(self) -> None:
        """Stop the lane once the steps handed to it have run."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def _raise_if_broken(self) -> None:
        if self._broken is not None:
            raise MeshDivergence(f"the lane stopped: {self._broken}")

    # ---- inside a step ---------------------------------------------------
    def share(self, value):
        """Rank 0's ``value``, on every rank."""
        self._raise_if_broken()
        if self.world == 1:
            return value
        msg = [value]
        dist.broadcast_object_list(msg, src=0, group=self._group)
        return msg[0]

    def check(self, key) -> None:
        """Raise ``MeshDivergence`` on every rank unless every rank is at
        ``key``."""
        self._agree(key, None)

    def program(self, key, run: Callable[[], Any]):
        """``run()``, one ring program, between two exchanges: before it,
        every rank must be about to run ``key``; after it, a failure on
        any rank raises on every rank (the failed rank's own error there,
        ``MeshPeerError`` elsewhere)."""
        self._agree(("run", key), None)
        try:
            value = run()
        except Exception as e:
            self._agree(("ran", key), e)
            raise
        self._agree(("ran", key), None)
        return value

    def _agree(self, tag, error: BaseException | None) -> None:
        self._raise_if_broken()
        if self.world == 1:
            if error is not None:
                raise error
            return
        seen: list = [None] * self.world
        mine = None if error is None else f"{type(error).__name__}: {error}"
        dist.all_gather_object(seen, (tag, mine), group=self._group)
        if error is not None:
            raise error
        for r, (t, err) in enumerate(seen):
            if t != seen[0][0]:
                # every rank sees the same list: all stop here alike
                self._broken = MeshDivergence(
                    f"rank {r} reached {t!r} where rank 0 reached "
                    f"{seen[0][0]!r}")
                raise self._broken
            if err is not None:
                raise MeshPeerError(f"rank {r} failed {t!r}: {err}")

    # ---- the lane --------------------------------------------------------
    def _lane(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending:
                    return
                if self._broken is not None:
                    step = self._pending.pop(0)
                    step.error = MeshDivergence(
                        f"the lane stopped: {self._broken}")
                    step.done.set()
                    continue
                step = self._pending.pop(0) if self.rank == 0 else None
            try:
                if self.world > 1:
                    step = self._follow(step)
            except BaseException as e:
                # the control group failed, or rank 0 ran a step this rank
                # was never given: every step handed over fails alike
                with self._cv:
                    self._broken = e
                    failed = self._pending + ([step] if step else [])
                    self._pending = []
                for s in failed:
                    s.error = MeshDivergence(f"the lane stopped: {e}")
                    s.done.set()
                return
            try:
                step.value = step.work(step.payload)
            except BaseException as e:   # the waiting caller raises it
                step.error = e
            step.done.set()

    def _follow(self, step: _Step | None) -> _Step:
        """Rank 0 announces ``step``; another rank takes rank 0's key and
        payload and the step of its own with that key."""
        msg = [None, None] if step is None else [step.key, step.payload]
        dist.broadcast_object_list(msg, src=0, group=self._group)
        if self.rank == 0:
            return step
        key, payload = msg
        with self._cv:
            if not self._cv.wait_for(
                    lambda: any(s.key == key for s in self._pending),
                    WAIT_S):
                raise MeshDivergence(
                    f"rank 0 ran the step {key!r}, which this rank was not "
                    f"given within {WAIT_S:g} s")
            mine = next(s for s in self._pending if s.key == key)
            self._pending.remove(mine)
        mine.payload = payload
        return mine
