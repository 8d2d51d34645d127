"""Audio datasets: manifests, segment sampling, zip paths."""
