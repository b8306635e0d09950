from repro_torch.embedding.cache import (CachedShadowedTable, CacheStats,
                                         CacheThrash, PrefetchPlan)
from repro_torch.embedding.tables import (ShadowedTable, TableSpec,
                                          init_table, live_shadow, lookup,
                                          lookup_quantized, make_shadowed,
                                          multi_table_lookup, rebuild_shadow,
                                          shadow_consistent, strip_shadow)

__all__ = ["CacheStats", "CacheThrash", "CachedShadowedTable",
           "PrefetchPlan", "ShadowedTable", "TableSpec", "init_table", "live_shadow",
           "lookup", "lookup_quantized", "make_shadowed",
           "multi_table_lookup", "rebuild_shadow", "shadow_consistent",
           "strip_shadow"]
