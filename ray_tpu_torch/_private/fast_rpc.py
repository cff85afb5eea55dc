"""Daemon-side RPC server factory.

The reference's `make_server` returns a server on its native epoll pump
when that pump is built, else the asyncio `rpc.RpcServer`. The port has
no native pump yet (ROADMAP A1, second part), so daemons always get the
asyncio server; they call this factory and stay agnostic of which.
"""

from __future__ import annotations

from typing import Callable

from ray_tpu_torch._private import rpc


def make_server(handlers: dict[str, Callable], name: str = "server",
                on_connect: Callable | None = None):
    return rpc.RpcServer(handlers, name=name, on_connect=on_connect)
