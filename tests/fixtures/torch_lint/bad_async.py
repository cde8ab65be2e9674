"""Seeded negatives for the ``async-blocking`` concurrency rule
(analyzed with rules forced on, as if it lived under serve/)."""

import asyncio
import subprocess
import time


async def blocking_tick(lock, fut, thread):
    time.sleep(0.1)                     # host sleep on the loop
    subprocess.run(["true"])            # subprocess on the loop
    open("/tmp/raft_fixture", "w")      # blocking file IO  # raft-lint: disable=atomic-write
    fut.result()                        # blocks until resolution
    thread.join()                       # blocks until thread exit
    lock.acquire()                      # unbounded lock wait


def _blocking_helper():
    time.sleep(1.0)


async def transitive():
    _blocking_helper()                  # taints through the sync helper


async def clean(lock, loop, fn, reader):
    await asyncio.sleep(0)              # loop-native sleep: fine
    lock.acquire(timeout=1.0)           # bounded wait: fine
    if lock.acquire(False):             # non-blocking probe: fine
        lock.release()
    ",".join(["a", "b"])                # str.join, not Thread.join
    await loop.run_in_executor(None, _blocking_helper)  # pushed off-loop
    await reader.readline()
