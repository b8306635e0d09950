from repro_torch.core.device import resolve_device
from repro_torch.core.jagged import NEG_SEG, positions, segment_ids

__all__ = ["NEG_SEG", "positions", "segment_ids", "resolve_device"]
