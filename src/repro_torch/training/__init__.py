"""Training: schedules, AdamW with f32 masters, the train step."""
