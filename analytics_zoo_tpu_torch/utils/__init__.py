"""Framework-free helpers of the port (copies of the reference's)."""
