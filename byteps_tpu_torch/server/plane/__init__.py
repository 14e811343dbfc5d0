"""The server plane of the port. Only the placement ring is here so far:
the sharded weight update walks it to assign bucket groups to replicas
(``sharded_update.py``). The managed plane itself (replicated shards,
rebalancing, key migration) is not ported yet (ROADMAP.md, queue 1,
item 8)."""
