from repro_torch.kernels.jagged_lookup.ops import (KERNEL_LAUNCHES,
                                                   dedup_rows,
                                                   scatter_add_rows,
                                                   scatter_add_weighted_rows,
                                                   unique_pairs,
                                                   weighted_run_totals)

__all__ = ["KERNEL_LAUNCHES", "dedup_rows", "scatter_add_rows",
           "scatter_add_weighted_rows", "unique_pairs", "weighted_run_totals"]
