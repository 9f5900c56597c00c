"""AdamW (``adamw``) and learning-rate schedules (``schedules``)."""
