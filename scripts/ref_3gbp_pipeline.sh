#!/bin/bash
# Reference-binary 3 Gbp pipeline: genome gen -> PE reads -> index -> align.
# Produces the reference comparison row for the north-star config
# (BASELINE.json config: 100 bp PE vs 3 Gbp) — VERDICT r2 item 1.
#
# The genome is emitted as 24 equal chromosomes (human-like; the reference
# simreads segfaults on a single 3 Gbp entry) and the PE reads come from
# biokanga's simulator so the reference and our rows share ONE input
# set (scripts/sim_3gbp_reads.py).
# Run in background; stage timings land in $DIR/stage_times.txt.
set -e
REPO=/root/repo
DIR=${1:-/root/data3g}
BP=${2:-3000000000}
BIN=$REPO/refbuild/bin/biokanga
mkdir -p "$DIR"
cd "$DIR"
T=stage_times.txt
: > $T

stamp() { echo "$1 $(date +%s.%N)" >> $T; }

stamp gen_start
if [ ! -f g.fa.24 ]; then
  python3 $REPO/scripts/gen_genome_fasta.py "$DIR" --bp $BP --seed 31 --chroms 24
  touch g.fa.24
fi
stamp gen_done

stamp simreads_start
if [ ! -f r1.fa ]; then
  python3 $REPO/scripts/sim_3gbp_reads.py "$DIR" --pairs 262144 --chroms 24
fi
stamp simreads_done

# no /usr/bin/time in this image: sample peak RSS from /proc
rss_monitor() { # pidfile outfile
  local peak=0 rss
  while kill -0 "$1" 2>/dev/null; do
    rss=$(awk '/VmRSS/{print $2}' /proc/$1/status 2>/dev/null || echo 0)
    [ "${rss:-0}" -gt "$peak" ] && peak=$rss
    sleep 5
  done
  echo "peak_rss_kb $peak" > "$2"
}

stamp index_start
if [ ! -f g.sfx ]; then
  nice -n 15 $BIN index -i g.fa -o g.sfx -r t -T2 -F idx.log &
  PID=$!; rss_monitor $PID index_time.txt
  wait $PID
fi
stamp index_done

stamp align_start
nice -n 15 $BIN align -i r1.fa -u r2.fa -U1 -d 100 -D 600 -I g.sfx -o ref3g.sam \
  -M5 -T2 -F aln.log &
PID=$!; rss_monitor $PID align_time.txt
wait $PID
stamp align_done
echo DONE >> $T
