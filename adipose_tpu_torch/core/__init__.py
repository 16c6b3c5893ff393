"""Framework-free configuration and host IO."""
