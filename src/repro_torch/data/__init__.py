"""Host-side data path of the port: synthetic scenes and shape buckets."""
