"""Distribution and attention over caches. Port of ``repro/parallel``:
the sharding plans (``sharding``), the collectives over named mesh axes
(``collectives``), and decode attention over whole, sequence-sharded and
paged caches (``decode_attn``)."""
