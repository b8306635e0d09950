from repro_torch.embedding.tables import (ShadowedTable, live_shadow, lookup,
                                          make_shadowed, rebuild_shadow,
                                          shadow_consistent, strip_shadow)

__all__ = ["ShadowedTable", "live_shadow", "lookup", "make_shadowed",
           "rebuild_shadow", "shadow_consistent", "strip_shadow"]
