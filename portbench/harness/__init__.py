"""What every cell shares: finding files by name, the device, seeded weights
and inputs, spans and the profiler's trace, the checks and the result line."""
