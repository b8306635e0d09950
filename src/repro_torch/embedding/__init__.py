from repro_torch.embedding.tables import (ShadowedTable, live_shadow, lookup,
                                          make_shadowed, shadow_consistent)

__all__ = ["ShadowedTable", "live_shadow", "lookup", "make_shadowed",
           "shadow_consistent"]
