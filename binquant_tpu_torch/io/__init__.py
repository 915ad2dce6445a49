"""Engine pipeline, emission and the replay harness."""
