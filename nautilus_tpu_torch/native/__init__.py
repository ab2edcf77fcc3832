"""The port's native bag-reader source (bagreader.cc), shipped as package
data and compiled with g++ on first use by ingest/native.py."""
