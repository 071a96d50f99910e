// faultfs: syscall-level disk fault injection as an LD_PRELOAD shim.
//
// Role parity with the reference's CharybdeFS integration
// (charybdefs/src/jepsen/charybdefs.clj:40-85): inject EIO (or any
// errno) into file operations — all ops, a percentage of ops, or
// delays — and clear faults at runtime. Where the reference mounts a
// C++ FUSE passthrough filesystem over the data directory (built from
// source on the node, controlled over Thrift), this build intercepts
// the libc calls of the TARGET PROCESS directly: no kernel mount, no
// privileged /dev/fuse, works identically in containers, and faults
// scope to the database process instead of every user of the mount.
//
// Control plane: a config file (path in JEPSEN_FAULTFS_CONF) re-read
// whenever its mtime changes, with lines:
//
//     prefix=/var/lib/db      afflicted path prefix (required)
//     mode=none|fail|flaky|delay
//     errno=5                 errno for fail/flaky (default EIO)
//     probability=10          percent of ops failing in flaky mode
//     delay_us=100000         added latency in delay mode
//
// The nemesis (jepsen_tpu/faultfs.py) writes this file over the
// control plane; the DB's daemon is started with LD_PRELOAD pointing
// here.
//
// Build: g++ -O2 -shared -fPIC -o faultfs.so faultfs.cc -ldl

#define _GNU_SOURCE 1
#include <cerrno>
#include <cstdarg>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <dlfcn.h>
#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

typedef int (*open_t)(const char *, int, ...);
typedef int (*openat_t)(int, const char *, int, ...);
typedef ssize_t (*read_t)(int, void *, size_t);
typedef ssize_t (*write_t)(int, const void *, size_t);
typedef ssize_t (*pread_t)(int, void *, size_t, off_t);
typedef ssize_t (*pwrite_t)(int, const void *, size_t, off_t);
typedef int (*fsync_t)(int);
typedef int (*close_t)(int);

open_t real_open;
openat_t real_openat;
read_t real_read;
write_t real_write;
pread_t real_pread;
pwrite_t real_pwrite;
fsync_t real_fsync;
fsync_t real_fdatasync;
close_t real_close;

struct Config {
  char prefix[1024];
  int mode;  // 0 none, 1 fail, 2 flaky, 3 delay
  int err;
  int probability;  // percent, for flaky
  long delay_us;
};

Config cfg = {"", 0, EIO, 0, 0};
long long cfg_stamp = -1;
const char *cfg_path = nullptr;
unsigned int rng_state = 12345;

constexpr int MAX_FDS = 65536;
bool afflicted[MAX_FDS];

void init_real() {
  if (real_open) return;
  real_open = (open_t)dlsym(RTLD_NEXT, "open");
  real_openat = (openat_t)dlsym(RTLD_NEXT, "openat");
  real_read = (read_t)dlsym(RTLD_NEXT, "read");
  real_write = (write_t)dlsym(RTLD_NEXT, "write");
  real_pread = (pread_t)dlsym(RTLD_NEXT, "pread");
  real_pwrite = (pwrite_t)dlsym(RTLD_NEXT, "pwrite");
  real_fsync = (fsync_t)dlsym(RTLD_NEXT, "fsync");
  real_fdatasync = (fsync_t)dlsym(RTLD_NEXT, "fdatasync");
  real_close = (close_t)dlsym(RTLD_NEXT, "close");
  cfg_path = getenv("JEPSEN_FAULTFS_CONF");
  // Seed from pid AND the clock: consecutive pids alone give rand_r
  // correlated first draws, which biases flaky-mode fault rates for
  // fleets of short-lived processes.
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  rng_state = (unsigned int)getpid() * 2654435761u ^
              (unsigned int)ts.tv_nsec;
}

void reload_config() {
  if (!cfg_path) return;
  struct stat st;
  if (stat(cfg_path, &st) != 0) {
    cfg.mode = 0;
    return;
  }
  // Nanosecond + size keyed: two config flips within the same second
  // must not be coalesced (a long-lived DB process would keep the old
  // fault mode).
  long long stamp = (long long)st.st_mtime * 1000000000LL +
                    st.st_mtim.tv_nsec + st.st_size;
  if (stamp == cfg_stamp) return;
  cfg_stamp = stamp;
  // Use the REAL calls so config reads never recurse into the shim.
  int fd = real_open(cfg_path, O_RDONLY);
  if (fd < 0) return;
  char buf[4096];
  ssize_t n = real_read(fd, buf, sizeof(buf) - 1);
  real_close(fd);
  if (n <= 0) return;
  buf[n] = 0;
  Config nc = {"", 0, EIO, 0, 0};
  char *save = nullptr;
  for (char *line = strtok_r(buf, "\n", &save); line;
       line = strtok_r(nullptr, "\n", &save)) {
    char *eq = strchr(line, '=');
    if (!eq) continue;
    *eq = 0;
    const char *key = line, *val = eq + 1;
    if (!strcmp(key, "prefix")) {
      snprintf(nc.prefix, sizeof(nc.prefix), "%s", val);
    } else if (!strcmp(key, "mode")) {
      nc.mode = !strcmp(val, "fail")    ? 1
                : !strcmp(val, "flaky") ? 2
                : !strcmp(val, "delay") ? 3
                                        : 0;
    } else if (!strcmp(key, "errno")) {
      nc.err = atoi(val);
    } else if (!strcmp(key, "probability")) {
      nc.probability = atoi(val);
    } else if (!strcmp(key, "delay_us")) {
      nc.delay_us = atol(val);
    }
  }
  cfg = nc;
}

// Does this path fall under the configured prefix? Independent of the
// CURRENT mode: fds opened while faults are off must still be tracked,
// so a later mode flip afflicts the DB's long-lived WAL/data fds.
bool path_in_prefix(const char *path) {
  reload_config();
  if (!cfg.prefix[0] || !path) return false;
  return strncmp(path, cfg.prefix, strlen(cfg.prefix)) == 0;
}

bool path_afflicted(const char *path) {
  return path_in_prefix(path) && cfg.mode != 0;
}

// Should THIS operation on an afflicted fd fault?  Returns errno to
// inject, or 0 to pass through (possibly after a delay). Callers have
// just run reload_config() via path_afflicted()/is_afflicted(), so the
// config is fresh — no second stat here.
int roll() {
  switch (cfg.mode) {
    case 1:
      return cfg.err;
    case 2:
      return (int)(rand_r(&rng_state) % 100) < cfg.probability ? cfg.err
                                                               : 0;
    case 3:
      usleep(cfg.delay_us);
      return 0;
    default:
      return 0;
  }
}

void track(int fd, const char *path) {
  if (fd >= 0 && fd < MAX_FDS) afflicted[fd] = path_in_prefix(path);
}

bool is_afflicted(int fd) {
  if (fd < 0 || fd >= MAX_FDS) return false;
  if (!afflicted[fd]) return false;
  reload_config();
  return cfg.mode != 0;
}

}  // namespace

extern "C" {

int open(const char *path, int flags, ...) {
  init_real();
  mode_t mode = 0;
  if (flags & O_CREAT) {
    va_list ap;
    va_start(ap, flags);
    mode = va_arg(ap, mode_t);
    va_end(ap);
  }
  if (path_afflicted(path)) {
    int e = roll();
    if (e) {
      errno = e;
      return -1;
    }
  }
  int fd = real_open(path, flags, mode);
  track(fd, path);
  return fd;
}

int openat(int dirfd, const char *path, int flags, ...) {
  init_real();
  mode_t mode = 0;
  if (flags & O_CREAT) {
    va_list ap;
    va_start(ap, flags);
    mode = va_arg(ap, mode_t);
    va_end(ap);
  }
  // Only absolute paths are prefix-checked; relative-at paths pass
  // (the DB data dirs we afflict are configured absolute).
  if (path && path[0] == '/' && path_afflicted(path)) {
    int e = roll();
    if (e) {
      errno = e;
      return -1;
    }
  }
  int fd = real_openat(dirfd, path, flags, mode);
  if (path && path[0] == '/') track(fd, path);
  return fd;
}

#define RW_GUARD(fd)      \
  init_real();            \
  if (is_afflicted(fd)) { \
    int e = roll();       \
    if (e) {              \
      errno = e;          \
      return -1;          \
    }                     \
  }

ssize_t read(int fd, void *buf, size_t n) {
  RW_GUARD(fd);
  return real_read(fd, buf, n);
}

ssize_t write(int fd, const void *buf, size_t n) {
  RW_GUARD(fd);
  return real_write(fd, buf, n);
}

ssize_t pread(int fd, void *buf, size_t n, off_t off) {
  RW_GUARD(fd);
  return real_pread(fd, buf, n, off);
}

ssize_t pwrite(int fd, const void *buf, size_t n, off_t off) {
  RW_GUARD(fd);
  return real_pwrite(fd, buf, n, off);
}

int fsync(int fd) {
  RW_GUARD(fd);
  return real_fsync(fd);
}

int fdatasync(int fd) {
  RW_GUARD(fd);
  return real_fdatasync(fd);
}

int close(int fd) {
  init_real();
  if (fd >= 0 && fd < MAX_FDS) afflicted[fd] = false;
  return real_close(fd);
}

// LFS 64-bit aliases: glibc routes large-file-aware callers (the JVM,
// anything built with _FILE_OFFSET_BITS=64 on 32-bit, dlopen'd libs)
// through these names, so they must interpose too.

int open64(const char *path, int flags, ...) {
  init_real();
  mode_t mode = 0;
  if (flags & O_CREAT) {
    va_list ap;
    va_start(ap, flags);
    mode = va_arg(ap, mode_t);
    va_end(ap);
  }
  if (path_afflicted(path)) {
    int e = roll();
    if (e) {
      errno = e;
      return -1;
    }
  }
  int fd = real_open(path, flags | O_LARGEFILE, mode);
  track(fd, path);
  return fd;
}

int openat64(int dirfd, const char *path, int flags, ...) {
  init_real();
  mode_t mode = 0;
  if (flags & O_CREAT) {
    va_list ap;
    va_start(ap, flags);
    mode = va_arg(ap, mode_t);
    va_end(ap);
  }
  if (path && path[0] == '/' && path_afflicted(path)) {
    int e = roll();
    if (e) {
      errno = e;
      return -1;
    }
  }
  int fd = real_openat(dirfd, path, flags | O_LARGEFILE, mode);
  if (path && path[0] == '/') track(fd, path);
  return fd;
}

int creat(const char *path, mode_t mode) {
  return open(path, O_CREAT | O_WRONLY | O_TRUNC, mode);
}

int creat64(const char *path, mode_t mode) {
  return open64(path, O_CREAT | O_WRONLY | O_TRUNC, mode);
}

ssize_t pread64(int fd, void *buf, size_t n, off_t off) {
  RW_GUARD(fd);
  return real_pread(fd, buf, n, off);
}

ssize_t pwrite64(int fd, const void *buf, size_t n, off_t off) {
  RW_GUARD(fd);
  return real_pwrite(fd, buf, n, off);
}

FILE *fopen(const char *path, const char *fmode) {
  init_real();
  typedef FILE *(*fopen_t)(const char *, const char *);
  static fopen_t real_fopen;
  if (!real_fopen) real_fopen = (fopen_t)dlsym(RTLD_NEXT, "fopen");
  if (path_afflicted(path)) {
    int e = roll();
    if (e) {
      errno = e;
      return nullptr;
    }
  }
  FILE *f = real_fopen(path, fmode);
  if (f) track(fileno(f), path);
  return f;
}

FILE *fopen64(const char *path, const char *fmode) {
  init_real();
  typedef FILE *(*fopen_t)(const char *, const char *);
  static fopen_t real_fopen64;
  if (!real_fopen64)
    real_fopen64 = (fopen_t)dlsym(RTLD_NEXT, "fopen64");
  if (path_afflicted(path)) {
    int e = roll();
    if (e) {
      errno = e;
      return nullptr;
    }
  }
  FILE *f = real_fopen64(path, fmode);
  if (f) track(fileno(f), path);
  return f;
}

}  // extern "C"
