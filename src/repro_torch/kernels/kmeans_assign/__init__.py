"""Batched K-means passes: Lloyd statistics and the paired final assignment + IMI histogram."""
