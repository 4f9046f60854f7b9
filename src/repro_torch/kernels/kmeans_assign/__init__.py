"""K-means passes: Lloyd statistics, the paired final assignment + IMI histogram, and nearest-centroid assignment (batched, and one problem of any width)."""
