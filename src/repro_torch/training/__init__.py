"""Training of the port: LR schedules, AdamW, the trainer and Mixture-of-Students distillation."""
