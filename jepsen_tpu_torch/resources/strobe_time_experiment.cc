// strobe_time_experiment: alternately jump the wall clock forward and
// back by <delta> ms every <period> ms for <duration> s, using
// RELATIVE settimeofday bumps on a nanosleep cadence.
//
// Role parity with the reference's experimental variant
// (jepsen/resources/strobe-time-experiment.c:151-205), which it ships
// but never compiles on nodes (nemesis/time.clj:38-41 compiles only
// bump-time and strobe-time); this port keeps the same status — on
// disk for operators chasing drift-sensitive bugs, not part of
// install_tools. The difference from strobe_time.cc: bumps are
// relative to whatever the clock currently reads (so concurrent NTP
// corrections COMPOUND with the strobe — the effect being
// experimented with), where strobe_time recomputes absolute targets
// from CLOCK_MONOTONIC and never drifts.
//
// --print-only prints the bump count it WOULD perform and exits
// without touching the clock (framework self-tests).
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <sys/time.h>
#include <unistd.h>

static long long mono_us() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (long long)ts.tv_sec * 1000000LL + ts.tv_nsec / 1000;
}

int main(int argc, char **argv) {
  bool print_only = false;
  long long args[3];
  int n = 0;
  for (int i = 1; i < argc; i++) {
    if (!strcmp(argv[i], "--print-only")) {
      print_only = true;
    } else if (n < 3) {
      args[n++] = atoll(argv[i]);
    }
  }
  if (n != 3) {
    fprintf(stderr,
            "usage: strobe_time_experiment [--print-only] <delta-ms> "
            "<period-ms> <duration-s>\n");
    return 2;
  }
  long long delta_ms = args[0], period_ms = args[1], duration_s = args[2];
  if (period_ms <= 0) {
    fprintf(stderr, "period-ms must be positive, got %lld\n", period_ms);
    return 2;
  }

  if (print_only) {
    printf("%lld\n", duration_s * 1000LL / period_ms);
    return 0;
  }

  long long end_us = mono_us() + duration_s * 1000000LL;
  struct timespec period;
  period.tv_sec = period_ms / 1000;
  period.tv_nsec = (period_ms % 1000) * 1000000LL;

  long long bumps = 0;
  int direction = 1;  // +delta first, then -delta, alternating
  while (mono_us() < end_us) {
    struct timeval now;
    gettimeofday(&now, nullptr);
    long long us = (long long)now.tv_sec * 1000000LL + now.tv_usec +
                   direction * delta_ms * 1000LL;
    struct timeval target;
    target.tv_sec = us / 1000000LL;
    target.tv_usec = us % 1000000LL;
    if (settimeofday(&target, nullptr) != 0) {
      perror("settimeofday");
      return 1;
    }
    bumps++;
    direction = -direction;
    struct timespec rem = period;
    while (nanosleep(&rem, &rem) != 0) {
      // interrupted: keep sleeping the remainder
    }
  }
  printf("%lld\n", bumps);
  return 0;
}
