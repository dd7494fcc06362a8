"""Workflow event listeners (ray parity: python/ray/workflow/
event_listener.py + the event-step machinery in workflow_executor).

``wait_for_event(MyListener, *args)`` binds an event step into a DAG:
when execution reaches it, the listener polls for the external event,
the payload is CHECKPOINTED like any step result (a resumed workflow
never re-waits for an event it already observed), and
``event_checkpointed`` is called exactly once after the checkpoint is
durable — the commit hook for systems that need an ack (e.g. deleting
a queue message only after the workflow can never ask for it again).

Example::

    class QueueListener(EventListener):
        def __init__(self, queue_url):
            self.queue_url = queue_url

        def poll_for_event(self):
            msg = my_queue.receive(self.queue_url)   # blocks
            return msg.body

        def event_checkpointed(self, event):
            my_queue.ack(self.queue_url)

    dag = process.bind(workflow.wait_for_event(QueueListener, url))
    workflow.run(dag)
"""

from __future__ import annotations

import inspect
import time
from typing import Any

from ray_tpu_torch.dag import DAGNode


class EventListener:
    """Subclass contract for external events. ``poll_for_event`` may be
    sync or async; it blocks until the event arrives and returns the
    payload. ``event_checkpointed`` runs after the payload is durably
    checkpointed (at-least-once: a crash between the two replays the
    checkpoint, not the poll)."""

    def poll_for_event(self) -> Any:
        raise NotImplementedError

    def event_checkpointed(self, event: Any) -> None:
        pass


class TimerListener(EventListener):
    """Fires at an absolute unix timestamp (ray parity: the workflow
    examples' timer listener)."""

    def __init__(self, at_timestamp: float):
        self.at = float(at_timestamp)

    def poll_for_event(self) -> float:
        delay = self.at - time.time()
        if delay > 0:
            time.sleep(delay)
        return self.at


class EventNode(DAGNode):
    """DAG node representing one event step."""

    def __init__(self, listener_cls, args, kwargs):
        self._listener_cls = listener_cls
        self._bound_args = list(args)
        self._bound_kwargs = dict(kwargs)

    @property
    def name(self) -> str:
        return f"event::{self._listener_cls.__name__}"

    def poll(self, args=None, kwargs=None) -> Any:
        """Instantiate the listener with RESOLVED args (upstream DAG
        nodes already executed by the caller) and block for the event."""
        listener = self._listener_cls(
            *(self._bound_args if args is None else args),
            **(self._bound_kwargs if kwargs is None else kwargs),
        )
        event = listener.poll_for_event()
        if inspect.iscoroutine(event):
            import asyncio

            event = asyncio.run(event)
        return listener, event


def wait_for_event(listener_cls, *args, **kwargs) -> EventNode:
    """Bind an event step (ray parity: workflow.wait_for_event)."""
    if not (isinstance(listener_cls, type)
            and issubclass(listener_cls, EventListener)):
        raise TypeError(
            "wait_for_event expects an EventListener subclass, got "
            f"{listener_cls!r}"
        )
    return EventNode(listener_cls, args, kwargs)
