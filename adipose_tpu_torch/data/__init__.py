"""Host-side datasets and statistics, and device-side augmentation."""
