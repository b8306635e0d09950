from repro_torch.data.loader import GRLoader
from repro_torch.data.synthetic import SyntheticKuaiRand

__all__ = ["GRLoader", "SyntheticKuaiRand"]
