"""Seconds the shard runner's card workers wait for the issuing turn (the
program's `shards/turn_wait` spans) over the seconds of the shard bodies
(`shards/body`), summed over the cards, in %, over the traced stretch
(host clock). Near 75% on four cards, one interpreter serializes them.
Several cards only."""

from benchmark.program_trace import seconds


def read(run):
    if run.cell.chips < 2:
        return None
    body, wait = seconds(run, "shards/body"), seconds(run, "shards/turn_wait")
    if not body or wait is None:
        return None
    return 100.0 * wait / body
