"""Training: SatCLIP contrastive pretraining and the generic fit loop."""
