"""GNN training: AdamW, learning-rate schedules, the train step."""
