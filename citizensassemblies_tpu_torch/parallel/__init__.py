"""Distributed paths over the world's mesh: chain-parallel Monte-Carlo
(``parallel/mc``), the row-sharded dual LP and face master
(``parallel/solver``) and the instance sweep (``parallel/sweep``)."""
