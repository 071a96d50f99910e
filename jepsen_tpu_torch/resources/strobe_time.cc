// strobe_time: oscillate the wall clock between true time and
// true time + delta, flipping every <period> ms for <duration> s.
//
// Role parity with the reference's strobe tool
// (jepsen/resources/strobe-time.c:118-170): the true time is anchored
// to CLOCK_MONOTONIC captured at startup, so repeated settimeofday
// calls don't compound drift — each flip recomputes absolute targets
// from the monotonic clock.
//
// --print-only prints the flip count it WOULD perform and exits
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
            "usage: strobe_time [--print-only] <delta-ms> <period-ms> "
            "<duration-s>\n");
    return 2;
  }
  long long delta_ms = args[0], period_ms = args[1], duration_s = args[2];

  struct timeval tv0;
  gettimeofday(&tv0, nullptr);
  long long wall0_us = (long long)tv0.tv_sec * 1000000LL + tv0.tv_usec;
  long long mono0_us = mono_us();
  long long end_us = mono0_us + duration_s * 1000000LL;

  long long flips = 0;
  bool skewed = false;
  if (print_only) {
    printf("%lld\n", duration_s * 1000LL / (period_ms ? period_ms : 1));
    return 0;
  }
  while (mono_us() < end_us) {
    long long true_us = wall0_us + (mono_us() - mono0_us);
    long long target_us = skewed ? true_us : true_us + delta_ms * 1000LL;
    struct timeval target;
    target.tv_sec = target_us / 1000000LL;
    target.tv_usec = target_us % 1000000LL;
    if (settimeofday(&target, nullptr) != 0) {
      perror("settimeofday");
      return 1;
    }
    skewed = !skewed;
    flips++;
    usleep(period_ms * 1000);
  }
  // restore true time
  long long true_us = wall0_us + (mono_us() - mono0_us);
  struct timeval target;
  target.tv_sec = true_us / 1000000LL;
  target.tv_usec = true_us % 1000000LL;
  settimeofday(&target, nullptr);
  printf("%lld\n", flips);
  return 0;
}
