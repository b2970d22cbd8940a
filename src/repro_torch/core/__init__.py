"""Framework-free pricing and scheduling, plus telemetry."""
