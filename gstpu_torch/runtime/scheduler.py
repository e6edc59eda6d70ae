"""Cooperative task scheduler: many streams, few threads.

Reinterpretation of the reference threadshare executor
(generic/threadshare/src/runtime/executor/scheduler.rs:36-80,
context.rs:148-276): a Context multiplexes many element tasks onto one
scheduling loop with a throttling wait period. Here the loop is also
the *batching window* — tasks enqueue device work, and one loop
iteration flushes a whole batch to the device (SURVEY.md §2.8 P2).

Tasks follow the reference Task state machine
(generic/threadshare/src/runtime/task.rs:28-66): Stopped → Prepared →
Started, with pause/flush triggers.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Callable, Optional

from gstpu_torch.utils.log import debug_category

CAT = debug_category("scheduler")


class TaskState(enum.Enum):
    STOPPED = "stopped"
    PREPARED = "prepared"
    STARTED = "started"
    PAUSED = "paused"
    EOS = "eos"
    ERROR = "error"


class TaskResult(enum.Enum):
    CONTINUE = "continue"   # did work; call again
    IDLE = "idle"           # no work available right now
    PAUSE = "pause"
    EOS = "eos"
    ERROR = "error"


class Task:
    """One cooperative unit: repeatedly calls `iterate()` while
    STARTED."""

    def __init__(self, name: str, iterate: Callable[[], TaskResult],
                 prepare: Callable[[], None] | None = None,
                 stop: Callable[[], None] | None = None):
        self.name = name
        self.iterate = iterate
        self.prepare_fn = prepare
        self.stop_fn = stop
        self.state = TaskState.STOPPED

    def prepare(self):
        if self.state is TaskState.STOPPED:
            if self.prepare_fn:
                self.prepare_fn()
            self.state = TaskState.PREPARED

    def start(self):
        if self.state in (TaskState.PREPARED, TaskState.PAUSED,
                          TaskState.STOPPED):
            self.state = TaskState.STARTED

    def pause(self):
        if self.state is TaskState.STARTED:
            self.state = TaskState.PAUSED

    def stop(self):
        if self.stop_fn and self.state is not TaskState.STOPPED:
            self.stop_fn()
        self.state = TaskState.STOPPED

    def run_once(self) -> TaskResult:
        if self.state is not TaskState.STARTED:
            return TaskResult.IDLE
        try:
            r = self.iterate()
        except Exception:
            CAT.error("task %s raised", self.name)
            import traceback
            traceback.print_exc()
            self.state = TaskState.ERROR
            return TaskResult.ERROR
        if r is TaskResult.EOS:
            self.state = TaskState.EOS
        elif r is TaskResult.PAUSE:
            self.state = TaskState.PAUSED
        elif r is TaskResult.ERROR:
            self.state = TaskState.ERROR
        return r


class Context:
    """A named scheduling context; `wait` is the throttle/batching
    period in seconds (reference context-wait, in ms there).

    Two execution modes:
    * embedded — a Pipeline drives iterate() from its run() loop
      (the round-1 model, used by non-live pipelines);
    * threaded — acquire(..., threaded=True) runs ONE OS thread for
      the whole context (reference executor/scheduler.rs:36-80): the
      thread sleeps in the reactor (epoll + timer heap) and wakes on
      socket readiness, timer deadlines or the throttle period.  Many
      elements (ts-udpsrc etc.) share that single thread — thread
      count is O(contexts), not O(streams).

    Tasks registered with a watched fd (watch_fd) run only when their
    socket is readable; plain tasks run every round.
    """

    _contexts: dict[str, "Context"] = {}
    _lock = threading.Lock()

    def __init__(self, name: str, wait: float = 0.0,
                 threaded: bool = False):
        self.name = name
        self.wait = wait
        self.tasks: list[Task] = []
        self.threaded = threaded
        self._reactor = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._ready: set[Task] = set()
        self._watched: dict[Task, object] = {}

    @classmethod
    def acquire(cls, name: str = "default", wait: float = 0.0,
                threaded: bool = False) -> "Context":
        with cls._lock:
            ctx = cls._contexts.get(name)
            if ctx is None:
                ctx = cls._contexts[name] = Context(name, wait, threaded)
            elif threaded:
                ctx.threaded = True
            return ctx

    @classmethod
    def release(cls, name: str) -> None:
        with cls._lock:
            ctx = cls._contexts.pop(name, None)
        if ctx is not None:
            ctx.shutdown()

    @property
    def reactor(self):
        if self._reactor is None:
            from gstpu_torch.runtime.reactor import Reactor
            self._reactor = Reactor()
        return self._reactor

    def add_task(self, task: Task) -> None:
        if task not in self.tasks:
            self.tasks.append(task)
        if self.threaded:
            self._ensure_thread()
            self.reactor.wake()

    def remove_task(self, task: Task) -> None:
        if task in self.tasks:
            self.tasks.remove(task)
        sock = self._watched.pop(task, None)
        if sock is not None and self._reactor is not None:
            self._reactor.unregister(sock)
        self._ready.discard(task)

    def watch_fd(self, task: Task, sock) -> None:
        """IO-driven scheduling: the task runs when sock is readable
        (reference Async<UdpSocket> + reactor wakeups)."""
        self._watched[task] = sock
        self.reactor.register_read(sock, lambda: self._ready.add(task))

    def add_timer(self, delay: float, callback, interval=None):
        return self.reactor.add_timer(delay, callback, interval)

    def iterate(self) -> bool:
        """Run one scheduling round. Returns True if any task did
        work."""
        if self._reactor is not None:
            self._reactor.poll(0.0)
        worked = False
        for t in list(self.tasks):
            if t in self._watched and t not in self._ready:
                continue
            r = t.run_once()
            if r is TaskResult.CONTINUE:
                worked = True
            else:
                self._ready.discard(t)
            if r in (TaskResult.EOS, TaskResult.ERROR):
                self.remove_task(t)
        return worked

    # -- threaded mode ---------------------------------------------------
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._thread_loop,
                name=f"gstpu-ctx-{self.name}", daemon=True)
            self._thread.start()

    def _thread_loop(self) -> None:
        CAT.log("context %s: thread up", self.name)
        while not self._stop.is_set():
            worked = self.iterate()
            if not worked:
                # park in epoll until IO/timer/wake (throttled)
                self.reactor.poll(self.wait if self.wait > 0 else 0.05)

    def shutdown(self) -> None:
        self._stop.set()
        if self._reactor is not None:
            self._reactor.wake()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self._reactor is not None:
            self._reactor.close()
            self._reactor = None

    def run_until_idle(self, timeout: float | None = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.tasks:
            worked = self.iterate()
            if not worked:
                if all(t.state in (TaskState.EOS, TaskState.ERROR,
                                   TaskState.STOPPED, TaskState.PAUSED)
                       for t in self.tasks):
                    return
                if self.wait:
                    time.sleep(self.wait)
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"context {self.name}: run timed out")
