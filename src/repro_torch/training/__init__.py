"""Training: schedules, AdamW with f32 masters, the train step (one device or sharded over a mesh), the int8 all-reduce and GPipe."""
