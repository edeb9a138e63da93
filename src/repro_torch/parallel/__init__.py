"""Attention over caches, by the layout of the cache. Port of
``repro/parallel``: so far the single-shard branches only."""
