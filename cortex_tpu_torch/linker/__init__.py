"""Edge decay (access reinforcement only, so far)."""
