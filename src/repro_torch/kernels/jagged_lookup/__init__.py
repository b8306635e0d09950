from repro_torch.kernels.jagged_lookup.ops import (KERNEL_LAUNCHES,
                                                   dedup_rows, gather_rows,
                                                   jagged_lookup,
                                                   multi_table_lookup,
                                                   scatter_add_rows,
                                                   scatter_add_weighted_rows,
                                                   unique_pairs,
                                                   weighted_run_totals)
from repro_torch.kernels.jagged_lookup.ref import jagged_lookup_ref

__all__ = ["KERNEL_LAUNCHES", "dedup_rows", "gather_rows", "jagged_lookup",
           "jagged_lookup_ref", "multi_table_lookup", "scatter_add_rows",
           "scatter_add_weighted_rows", "unique_pairs", "weighted_run_totals"]
