"""Host-side datasets and the device graph build."""
