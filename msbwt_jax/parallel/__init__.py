"""Multi-device sharding: sharded occurrence indexes with psum rank combine,
and data-parallel construction. The reference has no parallelism at all
(ref: README.md:42 — "is not parallelized"); this layer is the
multi-device scale-out story (SURVEY.md §5)."""
