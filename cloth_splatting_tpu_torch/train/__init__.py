"""Training: config, schedules, losses and the splat train step."""
