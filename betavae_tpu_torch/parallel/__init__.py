"""Data parallelism: one process a rank, the batch split by rows.

Counterpart of ``betavae_tpu/parallel/``.  :mod:`.mesh` joins a rank to
its process group (``data_parallel_mesh``), :mod:`.reduce` holds the batch
reductions over the group (``global_sum``, ``gather_rows``), :mod:`.launch`
starts the ranks, and :mod:`.dryrun` checks one data-parallel step.
"""
