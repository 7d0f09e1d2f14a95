from repro_torch.rl.sampling import generate

__all__ = ["generate"]
